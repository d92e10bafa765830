"""Reference-style benchmark matrix -> docs/results.csv (not committed).

Mirrors /root/reference/results/results_2023-11-08/run_tests.sh +
compile_results.py: the 5-genome set at k in {4, 21, 31}, N trials each,
recording the count-stage wall (subprocess, cold per trial — every trial
is a fresh process that pays its own parse; the XLA compiles are warmed
once first and excluded the same way the reference excludes interpreter
startup) and the subprocess max RSS. The reference's matrix additionally
covers 6 download-only datasets (archaeal-viruses-82 ... viruses-100,
results_2023-11-08/run_tests.sh:3-10) that are not bundled in the repo —
the 5-genome set is the one shipped dataset, so the matrix covers it at
the reference's k values plus the k=21 headline config. The CSV schema
matches the reference's (Dataset, Kmer Length, Program, Threads/Devices,
Time, deviation, RAM, deviation) so the two files line up row-for-row.

Run on the bench chip:  python scripts/bench_matrix.py [trials]
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DATA = Path("/root/reference/data/5-genomes-fna_gz")
KS = [4, 21, 31]
TRIALS = int(sys.argv[1]) if len(sys.argv) > 1 else 5

_CHILD = r"""
import json, resource, sys, time
sys.path.insert(0, {root!r})
from mercat2_tpu.utils import enable_compilation_cache
enable_compilation_cache()
import bench
files = sorted(__import__("pathlib").Path({data!r}).glob("*.fna.gz"))
k = {k}
bench._count_cold(files, k)   # pays this process's one-time XLA compiles
dts = []
for _ in range({trials}):
    total, n, dt = bench._count_cold(files, k)
    dts.append(dt)
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
print(json.dumps({{"dts": dts, "rss": rss, "bases": total, "kmers": n}}))
"""


def main() -> None:
    rows = []
    for k in KS:
        # one fresh process per k: it pays that k's compiles once, then
        # runs every trial cold-from-disk (the reference's matrix likewise
        # excludes interpreter/setup cost by scraping the in-run
        # "Time to count" line, results_2023-11-08/compile_results.py)
        p = subprocess.run(
            [sys.executable, "-c",
             _CHILD.format(root=str(ROOT), data=str(DATA), k=k,
                           trials=TRIALS)],
            capture_output=True, text=True,
        )
        line = [l for l in p.stdout.splitlines() if l.startswith("{")]
        assert p.returncode == 0 and line, (k, p.stderr[-800:])
        rec = json.loads(line[-1])
        dts, rsss = rec["dts"], [rec["rss"]]
        print(f"k={k}: trials {[round(d, 3) for d in dts]} "
              f"rss {rec['rss']:.0f} MB", flush=True)
        rows.append((k, dts, rsss))

    out = ROOT / "docs" / "results.csv"
    with open(out, "w") as w:
        print("Dataset,Kmer Length,Program,Devices,Time (Seconds),time-dev,"
              "RAM (M),ram-dev", file=w)
        for k, dts, rsss in rows:
            print(f"5genome-fna,{k},mercat2_tpu,1,"
                  f"{statistics.median(dts)},"
                  f"{statistics.stdev(dts) if len(dts) > 1 else 0.0},"
                  f"{statistics.median(rsss)},"
                  f"{statistics.stdev(rsss) if len(rsss) > 1 else 0.0}",
                  file=w)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
