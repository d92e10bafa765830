"""Parity of the device engine against the reference implementation, using the
reference's own ``find_kmers`` as a black-box oracle on the bundled data."""

from pathlib import Path

import pytest

from mercat2_tpu.engine.counter import count_file


@pytest.mark.parametrize(
    "relpath,k,min_count",
    [
        ("Scaffolds_with-NNN.fna", 5, 10),
        ("Scaffolds_with-NNN.fna", 21, 2),
        ("5-genomes-fna/RW1.fna", 5, 10),
        ("5-genomes-fna_gz/RW1.fna.gz", 5, 10),
        ("5-genomes-faa/RW1_pro.faa", 3, 10),
        ("5-genomes-faa_gz/RW1_pro.faa.gz", 3, 10),
    ],
)
def test_find_kmers_parity(ref_data, ref_kmers_module, relpath, k, min_count):
    path = ref_data / relpath
    if not path.exists():
        pytest.skip(f"{relpath} missing")
    expected = ref_kmers_module.find_kmers(Path(path), k, min_count)
    got = count_file(path, k, min_count).to_dict()
    assert got == expected
