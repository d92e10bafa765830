"""Uniform fixed-shape count path (engine.dispatch_packed_uniform).

The pipeline's single-device count stage routes every packable round
through ONE compiled program per (k, codec) family, which bounds a run's
compile time. These tests pin:

- table parity vs the per-file reference dispatchers, across multiple
  fixed-shape launch groups (shapes shrunk via monkeypatching),
- greedy grouping respects the file/gap/symbol limits,
- canonical codec selection (engine.codec.canonical_codec),
- the pipeline single-device path end-to-end vs per-file counts.
"""

import numpy as np
import pytest

from mercat2_tpu.engine.codec import (
    DNA_CODEC, PROTEIN_CODEC, canonical_codec, codec_for_bytes,
)
from mercat2_tpu.engine.counter import KmerCounter, NumpySource, fetch_tables


def _random_source(rng, n_rec, lo, hi, alphabet, codec):
    lens = rng.integers(lo, hi, size=n_rec)
    seqs = [rng.choice(alphabet, size=ln).astype(np.uint8) for ln in lens]
    seq = np.concatenate(seqs)
    rec = np.repeat(np.arange(n_rec), lens)
    return NumpySource(seq, rec, codec), seq, rec


@pytest.mark.parametrize("alphabet,k,min_count,dense", [
    (b"ACGT", 5, 2, True),    # small keyspace: dense one-hot slots
    (b"ACGT", 5, 2, False),   # same config through the sorted program
    (b"ACGT", 21, 3, True),   # big keyspace: sorted regardless
    (b"ACDEFGHIKLMNPQRSTVWY", 5, 2, True),  # 20^5 bins -> sorted
])
def test_uniform_matches_per_file(monkeypatch, alphabet, k, min_count, dense):
    monkeypatch.setattr(KmerCounter, "_UNIFORM_SYMS", 1 << 14)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_GAPS", 1 << 8)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_FILES", 4)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_CAP", 1 << 12)
    monkeypatch.setattr(KmerCounter, "_DENSE_SMALL_K", dense)
    rng = np.random.default_rng(7)
    alpha = np.frombuffer(alphabet, np.uint8)
    codec = codec_for_bytes(alpha)
    counter = KmerCounter(k, codec)

    sources, raw = [], []
    for _ in range(9):  # forces several launch groups at the tiny shapes
        s, seq, rec = _random_source(rng, 5, k, 400, alpha, codec)
        sources.append(s)
        raw.append((seq, rec))

    pendings = counter.dispatch_packed_uniform(sources, min_count)
    assert pendings is not None
    got = fetch_tables(pendings)
    for (seq, rec), tbl in zip(raw, got):
        exp = counter.count(seq, rec, min_count)
        assert np.array_equal(tbl.kmers, exp.kmers)
        assert np.array_equal(tbl.counts, exp.counts)


def test_uniform_rejects_oversized_file(monkeypatch):
    monkeypatch.setattr(KmerCounter, "_UNIFORM_SYMS", 1 << 10)
    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    codec = codec_for_bytes(alpha)
    counter = KmerCounter(5, codec)
    s, _, _ = _random_source(rng, 2, 800, 900, alpha, codec)
    assert counter.dispatch_packed_uniform([s], 2) is None


def test_uniform_cap_overflow_retries(monkeypatch):
    """n_out > _UNIFORM_CAP triggers the bucketed-cap retry, exact output."""
    monkeypatch.setattr(KmerCounter, "_UNIFORM_SYMS", 1 << 14)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_GAPS", 1 << 8)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_CAP", 64)  # tiny: overflows
    monkeypatch.setattr(KmerCounter, "_DENSE_SMALL_K", False)
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    codec = codec_for_bytes(alpha)
    counter = KmerCounter(6, codec)
    s, seq, rec = _random_source(rng, 3, 2000, 3000, alpha, codec)
    (pending,) = counter.dispatch_packed_uniform([s], 2)
    tbl = pending.table()
    exp = counter.count(seq, rec, 2)
    assert len(exp) > 64
    assert np.array_equal(tbl.kmers, exp.kmers)
    assert np.array_equal(tbl.counts, exp.counts)


def test_canonical_codec():
    assert canonical_codec(np.frombuffer(b"ACGT", np.uint8)) is DNA_CODEC
    assert canonical_codec(np.frombuffer(b"ACG", np.uint8)) is DNA_CODEC
    assert (
        canonical_codec(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8))
        is PROTEIN_CODEC
    )
    # N is in A-Z -> protein codec covers ambiguous nucleotide data
    assert canonical_codec(np.frombuffer(b"ACGNT", np.uint8)) is PROTEIN_CODEC
    # lowercase / digits: no canonical codec
    assert canonical_codec(np.frombuffer(b"ACGt", np.uint8)) is None
    assert canonical_codec(np.frombuffer(b"01", np.uint8)) is None


def test_pipeline_uniform_single_device(monkeypatch, tmp_path):
    """Single-device pipeline (mesh off, min_count>1) routes through the
    uniform path and matches per-file reference counts."""
    from mercat2_tpu.engine.counter import count_file
    from mercat2_tpu.pipeline import PipelineConfig, run_pipeline

    monkeypatch.setattr(KmerCounter, "_UNIFORM_SYMS", 1 << 16)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_GAPS", 1 << 10)
    rng = np.random.default_rng(11)
    indir = tmp_path / "in"
    indir.mkdir()
    for name in ("s1", "s2"):
        lines = []
        for r in range(30):
            seq = rng.choice(list("ACGT"), size=rng.integers(50, 300))
            lines.append(f">{name}_rec{r}")
            lines.append("".join(seq))
        (indir / f"{name}.fna").write_text("\n".join(lines) + "\n")

    out = tmp_path / "res"
    cfg = PipelineConfig(
        kmer=4, input_folder=str(indir), min_count=2, chunk_size_mb=0,
        output=str(out), skipclean=True, mesh="off",
    )
    run_pipeline(cfg)
    for name in ("s1", "s2"):
        exp = count_file(indir / f"{name}.fna", 4, 2).to_dict()
        got = {}
        with open(out / "tsv_nucleotide" / f"{name}_counts.tsv") as f:
            f.readline()
            for line in f:
                km, c = line.split()
                got[km] = int(c)
        assert got == exp


def test_pipeline_wave_salvage_falls_back(monkeypatch, tmp_path):
    """If dispatch_packed_uniform bails mid-round (rare mixed dense/sort
    shape edge), the wave loop salvages already-built sources into the
    adaptive path and results stay exact."""
    from mercat2_tpu.engine.counter import count_file
    from mercat2_tpu.pipeline import PipelineConfig, run_pipeline

    calls = {"n": 0}
    orig = KmerCounter.dispatch_packed_uniform

    def flaky(self, sources, min_count=1, workers=None, family=None,
              gap_family=None):
        calls["n"] += 1
        if calls["n"] == 1:
            return None  # first wave bails -> salvage to adaptive
        return orig(self, sources, min_count, workers, family, gap_family)

    monkeypatch.setattr(KmerCounter, "dispatch_packed_uniform", flaky)
    rng = np.random.default_rng(3)
    indir = tmp_path / "in"
    indir.mkdir()
    for name in ("a", "b", "c"):
        lines = []
        for r in range(10):
            seq = rng.choice(list("ACGT"), size=rng.integers(60, 200))
            lines.append(f">{name}{r}")
            lines.append("".join(seq))
        (indir / f"{name}.fna").write_text("\n".join(lines) + "\n")

    out = tmp_path / "res"
    run_pipeline(PipelineConfig(
        kmer=4, input_folder=str(indir), min_count=2, chunk_size_mb=0,
        output=str(out), skipclean=True, mesh="off",
    ))
    assert calls["n"] >= 1
    for name in ("a", "b", "c"):
        exp = count_file(indir / f"{name}.fna", 4, 2).to_dict()
        got = {}
        with open(out / "tsv_nucleotide" / f"{name}_counts.tsv") as f:
            f.readline()
            for line in f:
                km, c = line.split()
                got[km] = int(c)
        assert got == exp, name


def test_pipeline_oversized_file_mixes_with_uniform(monkeypatch, tmp_path):
    """A file exceeding the uniform cap routes to the adaptive path while
    the fitting files keep the uniform program; all tables exact."""
    from mercat2_tpu.engine.counter import count_file
    from mercat2_tpu.pipeline import PipelineConfig, run_pipeline

    monkeypatch.setattr(KmerCounter, "_UNIFORM_SYMS", 1 << 12)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_FAMILIES", (1 << 12,))
    monkeypatch.setattr(KmerCounter, "_UNIFORM_GAPS", 1 << 9)
    rng = np.random.default_rng(5)
    indir = tmp_path / "in"
    indir.mkdir()
    small = "".join(rng.choice(list("ACGT"), size=800))
    big = "".join(rng.choice(list("ACGT"), size=20_000))  # > 2^12 symbols
    (indir / "small.fna").write_text(f">s\n{small}\n")
    (indir / "big.fna").write_text(f">b\n{big}\n")

    out = tmp_path / "res"
    run_pipeline(PipelineConfig(
        kmer=4, input_folder=str(indir), min_count=2, chunk_size_mb=0,
        output=str(out), skipclean=True, mesh="off",
    ))
    for name in ("small", "big"):
        exp = count_file(indir / f"{name}.fna", 4, 2).to_dict()
        got = {}
        with open(out / "tsv_nucleotide" / f"{name}_counts.tsv") as f:
            f.readline()
            for line in f:
                km, c = line.split()
                got[km] = int(c)
        assert got == exp, name
