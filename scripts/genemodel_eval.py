"""Dev harness: native gene model vs golden Prodigal gene coordinates.

Per sample prints gene counts, stop-level precision/recall, exact
start+stop match rate, and the k=5 min-count-10 protein-table key Jaccard
vs golden tsv_prod (the pipeline-level gene-model metric).

    python scripts/genemodel_eval.py [samples...]
"""
from __future__ import annotations

import gzip
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GOLDEN = Path("/root/reference/results/2023-11-29/fna-5genomes-10")
DATA = Path("/root/reference/data/5-genomes-fna_gz")
K, MIN_COUNT = 5, 10


def _records(path):
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rt") as f:
        header, seq = None, []
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(seq)
                header, seq = line[1:], []
            elif line:
                seq.append(line)
        if header is not None:
            yield header, "".join(seq)


def _golden(sample):
    genes = set()          # (seqid, start, end, strand)
    stops = set()
    prots = []
    for header, seq in _records(GOLDEN / "prodigal" / f"{sample}_pro.faa"):
        parts = [p.strip() for p in header.split("#")]
        seqid = parts[0].rsplit("_", 1)[0]
        s, e, st = int(parts[1]), int(parts[2]), int(parts[3])
        genes.add((seqid, s, e, st))
        stops.add((seqid, e if st > 0 else s, st))
        prots.append(seq)
    return genes, stops, prots


def _table(prots):
    c = Counter()
    for p in prots:
        p = p.replace("*", "")
        for i in range(len(p) - K + 1):
            c[p[i : i + K]] += 1
    return Counter({k: v for k, v in c.items() if v >= MIN_COUNT})


def main():
    from mercat2_tpu.io.clean import remove_n
    from mercat2_tpu.orf.genemodel import call_genome
    from mercat2_tpu.orf.native import _BASE_LUT

    import os
    iters = int(os.environ.get("GM_ITERS", "2"))
    samples = sys.argv[1:] or ["RW1", "GIC31", "DJ", "RW2", "Rleg"]
    for sample in samples:
        gold_genes, gold_stops, gold_prots = _golden(sample)
        cleaned, _ = remove_n(DATA / f"{sample}.fna.gz", "/tmp/gm_clean")
        recs = [(h.split()[0], np.frombuffer(s.encode(), np.uint8))
                for h, s in _records(cleaned)]
        t0 = time.perf_counter()
        called = call_genome([_BASE_LUT[sb] for _, sb in recs], iters)
        t1 = time.perf_counter()
        ours_genes, ours_stops, prots = set(), set(), []
        for (seqid, _sb), genes in zip(recs, called):
            for g in genes:
                ours_genes.add((seqid, g.start, g.end, g.strand))
                ours_stops.add(
                    (seqid, g.end if g.strand > 0 else g.start, g.strand))
                prots.append(g.protein.decode())
        t2 = t1
        sp = len(gold_stops & ours_stops)
        gp = len(gold_genes & ours_genes)
        gt, ot = _table(gold_prots), _table(prots)
        shared = set(gt) & set(ot)
        jac = len(shared) / max(1, len(set(gt) | set(ot)))
        print(
            f"{sample}: genes {len(ours_genes)}/{len(gold_genes)} "
            f"({len(ours_genes)/max(1,len(gold_genes)):.2f}x) "
            f"stopP {sp/max(1,len(ours_stops)):.3f} "
            f"stopR {sp/max(1,len(gold_stops)):.3f} "
            f"exact {gp/max(1,len(gold_genes)):.3f} "
            f"keys {len(ot)}/{len(gt)} Jac {jac:.3f} "
            f"[train {t1-t0:.1f}s call {t2-t1:.1f}s]",
            flush=True,
        )


if __name__ == "__main__":
    main()
