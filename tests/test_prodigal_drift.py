"""Pin the native gene model's fidelity vs golden Prodigal (RW1).

docs/PRODIGAL_DRIFT.md records the full 5-genome evaluation
(scripts/prodigal_drift.py); this test re-derives the headline invariants
on the smallest genome so regressions in the gene model are caught:

- gene-count ratio within [0.8, 1.2] of Prodigal's (the old maximal-ORF
  fallback over-called ~6.6x here; the done criterion was <= 2x),
- stop precision and recall >= 0.9 (called genes end where Prodigal's do),
- k=5 min-count-10 protein-table key Jaccard vs golden tsv_prod >= 0.5
  (majority overlap; measured 1.0 on RW1, mean 0.87 across the set).
"""

import gzip
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path("/root/reference/results/2023-11-29/fna-5genomes-10")
DATA = Path("/root/reference/data/5-genomes-fna_gz")


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


def _table(prots, k=5, min_count=10):
    c = Counter()
    for p in prots:
        p = p.replace("*", "")
        for i in range(len(p) - k + 1):
            c[p[i : i + k]] += 1
    return {k_: v for k_, v in c.items() if v >= min_count}


@pytest.mark.skipif(not GOLDEN.exists(), reason="golden tree absent")
def test_gene_model_tracks_prodigal_on_rw1(tmp_path):
    from mercat2_tpu.io.clean import remove_n
    from mercat2_tpu.orf.genemodel import call_genome
    from mercat2_tpu.orf.native import _BASE_LUT

    gold_stops = set()
    gold_prots = []
    for header, seq in _records(GOLDEN / "prodigal" / "RW1_pro.faa"):
        parts = [p.strip() for p in header.split("#")]
        seqid = parts[0].rsplit("_", 1)[0]
        start, end, strand = int(parts[1]), int(parts[2]), int(parts[3])
        gold_stops.add((seqid, end if strand > 0 else start, strand))
        gold_prots.append(seq)

    cleaned, _ = remove_n(DATA / "RW1.fna.gz", tmp_path)
    recs = [(h.split()[0], np.frombuffer(s.encode(), np.uint8))
            for h, s in _records(cleaned)]
    called = call_genome([_BASE_LUT[sb] for _, sb in recs])
    native_stops = set()
    prots = []
    for (seqid, _), genes in zip(recs, called):
        for g in genes:
            native_stops.add(
                (seqid, g.end if g.strand > 0 else g.start, g.strand))
            prots.append(g.protein.decode())

    n_gold, n_native = len(gold_prots), len(prots)
    assert n_gold == 284
    assert 0.8 <= n_native / n_gold <= 1.2, (n_native, n_gold)
    hit = len(gold_stops & native_stops)
    assert hit / len(native_stops) >= 0.9, "stop precision regressed"
    assert hit / len(gold_stops) >= 0.9, "stop recall regressed"

    gt, ot = _table(gold_prots), _table(prots)
    shared = set(gt) & set(ot)
    jac = len(shared) / max(1, len(set(gt) | set(ot)))
    assert jac >= 0.5, f"tsv_prod key Jaccard {jac:.3f} lost its majority"


def test_gene_model_synthetic_roundtrip():
    """A synthetic 'genome' of repeated composition-biased genes separated
    by random intergenic DNA: the self-trained model must find ORFs in the
    planted regions, translate starts to M, and respect strand."""
    from mercat2_tpu.orf.genemodel import call_genome
    from mercat2_tpu.orf.native import _BASE_LUT

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    # codon pool biased like real coding DNA (no stops, GC3 bias)
    codons = [b"GCC", b"GAA", b"CTG", b"AAA", b"GAT", b"GGC", b"ATC", b"CGT"]
    parts = []
    gene_spans = []
    pos = 0
    for _ in range(40):
        inter = bases[rng.integers(0, 4, rng.integers(40, 120))].tobytes()
        parts.append(inter)
        pos += len(inter)
        body = b"".join(
            codons[i] for i in rng.integers(0, len(codons), 220)
        )
        gene = b"ATG" + body + b"TAA"
        gene_spans.append((pos + 1, pos + len(gene)))  # 1-based inclusive
        parts.append(gene)
        pos += len(gene)
    genome = np.frombuffer(b"".join(parts), np.uint8)

    called = call_genome([_BASE_LUT[genome]])[0]
    assert len(called) >= 30, f"only {len(called)} of 40 planted genes found"
    for g in called[:5]:
        assert g.protein.startswith(b"M")
        assert g.protein.endswith(b"*")
    # every called forward gene should land on a planted span's stop
    stops = {e for _, e in gene_spans}
    fwd = [g for g in called if g.strand > 0]
    on_target = sum(1 for g in fwd if g.end in stops)
    assert on_target / max(1, len(fwd)) >= 0.8


def test_gene_model_partial_edges():
    """Genes running off contig edges get partial flags and Edge starts."""
    from mercat2_tpu.orf.genemodel import MIN_SCORE, call_genes, train_model
    from mercat2_tpu.orf.native import _BASE_LUT

    rng = np.random.default_rng(1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    codons = [b"GCC", b"GAA", b"CTG", b"AAA", b"GAT", b"GGC", b"ATC", b"CGT"]

    def body(n):
        return b"".join(codons[i] for i in rng.integers(0, len(codons), n))

    # contig starts mid-gene (no start codon before the first stop), then
    # enough complete genes for the 4096-bin dicodon model to train
    parts = [body(300) + b"TAA"]
    for _ in range(30):
        parts.append(bases[rng.integers(0, 4, rng.integers(40, 120))].tobytes())
        parts.append(b"ATG" + body(220) + b"TAA")
    contig = b"".join(parts)
    codes = _BASE_LUT[np.frombuffer(contig, np.uint8)]
    model = train_model([codes])
    genes = call_genes(model, np.frombuffer(contig, np.uint8))
    assert genes, "no genes called on the synthetic contig"
    first = genes[0]
    assert first.start == 1 and first.partial[0] == "1"
    assert first.start_type == "Edge"
    assert not first.protein.startswith(b"M") or contig[:3] == b"ATG"
    assert all(g.score >= MIN_SCORE for g in genes)
