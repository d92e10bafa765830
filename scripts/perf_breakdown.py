"""Phase breakdown of the cold k=21 count (run on the real chip).

Prints per-phase wall times for: gzip+parse (threaded), group assembly
(encode+bitpack), device dispatch, n_out sync, table fetch. Run this to
decide which phase to optimize next.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

DATA_NT = Path("/root/reference/data/5-genomes-fna_gz")
K = int(sys.argv[1]) if len(sys.argv) > 1 else 21
RUNS = 3


def main() -> None:
    from mercat2_tpu.engine.codec import codec_for_alphabet
    from mercat2_tpu.engine.counter import KmerCounter, fetch_tables
    from mercat2_tpu.io.native import open_fasta_native
    from mercat2_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    files = sorted(DATA_NT.glob("*.fna.gz"))

    for run in range(RUNS + 1):  # run 0 = warmup
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(files)) as pool:
            sources = list(pool.map(open_fasta_native, files))
        t1 = time.perf_counter()
        alpha = np.zeros(0, np.uint8)
        for s in sources:
            alpha = np.union1d(alpha, s.alphabet())
        counter = KmerCounter(K, codec_for_alphabet(alpha.astype(np.uint8)))
        t2 = time.perf_counter()

        # segmented single-launch path (dispatch_packed_sources)
        pendings = counter.dispatch_packed_sources(sources, 10)
        t3 = time.perf_counter()
        build_t = t3 - t2  # host group assembly + launch enqueue
        disp_t = 0.0
        groups = [1]
        tables = fetch_tables(pendings)
        t4 = time.perf_counter()
        n = sum(len(t) for t in tables)
        total = sum(s.seq_len for s in sources)
        for s in sources:
            s.close()
        tag = "warm" if run else "WARMUP"
        print(
            f"[{tag}] total={t4-t0:.3f}s parse={t1-t0:.3f} plan={t2-t1:.3f} "
            f"build={build_t:.3f} dispatch={disp_t:.3f} "
            f"fetch(sync+d2h)={t4-t3:.3f} groups={len(groups)} "
            f"kmers={n} bases={total}"
        )


if __name__ == "__main__":
    main()
