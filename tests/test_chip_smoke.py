"""chip_smoke.py's seeded inputs and its comparison against the numpy
reference, at tiny sizes on the CPU."""

import gzip

import numpy as np
import pytest

import chip_smoke
from mercat2_tpu.engine.counter import KmerTable
from mercat2_tpu.report.tsv import write_counts_tsv

TINY = dict(genomes=3, genome_bp=40_000, contigs=(2, 5), elements=2,
            shared_elements=1, copies=8, proteomes=2, proteins=40,
            protein_len=80, domains=5)


def _read(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_inputs_are_seeded_and_shaped(tmp_path):
    nt, aa = chip_smoke.generate_inputs(tmp_path / "a", 3, TINY)
    nt2, _ = chip_smoke.generate_inputs(tmp_path / "b", 3, TINY)
    nt3, _ = chip_smoke.generate_inputs(tmp_path / "c", 4, TINY)
    genomes = sorted(nt.iterdir())
    assert [p.name for p in genomes] == [
        "genome1.fna.gz", "genome2.fna.gz", "genome3.fna.gz"]
    assert _read(genomes[0]) == _read(nt2 / "genome1.fna.gz")
    assert _read(genomes[0]) != _read(nt3 / "genome1.fna.gz")
    text = _read(genomes[0])
    seq = b"".join(ln for ln in text.split(b"\n") if not ln.startswith(b">"))
    assert len(seq) == TINY["genome_bp"]
    assert text.count(b">") >= 2 and b"N" in seq
    assert set(seq) <= set(b"ACGTN")
    prot = _read(aa / "proteome1.faa.gz")
    heads = [ln for ln in prot.split(b"\n") if ln.startswith(b">")]
    assert len(heads) == TINY["proteins"]
    assert b"*" in prot
    first = prot.split(b"\n")[1]
    assert first.startswith(b"M")


def test_counts_tsv_round_trip(tmp_path):
    kmers = np.frombuffer(b"AACAGTTT", np.uint8).reshape(-1, 2)
    table = KmerTable(kmers, np.array([12, 3, 10, 99], np.int64))
    write_counts_tsv(table, "s", tmp_path / "s_counts.tsv")
    got_k, got_c = chip_smoke.read_counts_tsv(tmp_path / "s_counts.tsv", 2)
    assert got_k.tolist() == [b"AA", b"CA", b"GT", b"TT"]
    assert got_c.tolist() == [12, 3, 10, 99]


def test_check_run_accepts_pipeline_and_rejects_tampering(tmp_path):
    """The CLI's output passes the reference comparison; one changed
    count fails it."""
    nt, _ = chip_smoke.generate_inputs(tmp_path / "in", 0, TINY)
    out = tmp_path / "run"
    wall = chip_smoke.run_cli(["-k", "9", "-c", "2", "-f", str(nt), "-o",
                               str(out), "-replace", "-mesh", "off"])
    assert wall > 0
    inputs = sorted(nt.iterdir())
    rows = chip_smoke.check_run(out, "nt", inputs, 9, 2)
    assert rows > 0
    tsv = out / "tsv_nucleotide" / "genome1_counts.tsv"
    lines = tsv.read_text().splitlines()
    kmer, count = lines[1].split("\t")
    lines[1] = f"{kmer}\t{int(count) + 1}"
    tsv.write_text("\n".join(lines) + "\n")
    with pytest.raises(AssertionError, match="differ from the numpy"):
        chip_smoke.check_run(out, "nt", inputs, 9, 2)


def test_without_accelerator_fails_with_ok_false(capsys):
    """On the CPU, without --rehearse, the script fails and its last line
    says ok false with the platform it found."""
    import json

    assert chip_smoke.main([]) == 3
    last = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(last)
    assert got["ok"] is False and got["device"]["platform"] == "cpu"
