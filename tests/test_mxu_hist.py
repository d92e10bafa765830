"""One-hot matmul dense histogram vs the sort engine and the oracle.

The dense path (ops.mxu_hist) must produce byte-identical tables to the
sorted path for every small keyspace: same bins, same counts, same
lexicographic order, same per-file min-count semantics
(/root/reference/lib/mercat2_kmers.py:73-76).
"""

import random

import numpy as np
import pytest

from mercat2_tpu.engine.codec import codec_for_bytes
from mercat2_tpu.engine.counter import KmerCounter, NumpySource
from mercat2_tpu.ops.mxu_hist import MXU_MAX_BINS, mxu_split

from oracle import naive_kmers


def _seq_rec(records):
    joined = "".join(records)
    seq = np.frombuffer(joined.encode("latin-1"), np.uint8)
    rec = np.repeat(
        np.arange(1, len(records) + 1, dtype=np.int64),
        [len(r) for r in records],
    )
    return seq, rec


def _records(rng, n_rec, alphabet, lo=0, hi=300):
    return [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(lo, hi)))
        for _ in range(n_rec)
    ]


def test_mxu_split_exact_cover():
    for k, s in [(3, 25), (5, 4), (7, 4), (2, 64), (1, 25)]:
        b1, b2 = mxu_split(k, s)
        assert b1 * b2 == s**k


@pytest.mark.parametrize("alphabet,k,min_count", [
    ("ACGT", 3, 1),
    ("ACGT", 5, 3),
    ("ACGT", 7, 2),          # 16384 bins == MXU_MAX_BINS exactly
    ("ACDEFGHIKLMNPQRSTVWYX", 3, 2),   # 21-symbol protein
])
def test_dense_matches_sort_and_oracle(alphabet, k, min_count):
    rng = random.Random(hash((alphabet, k)) & 0xFFFF)
    recs = _records(rng, 25, alphabet)
    seq, rec = _seq_rec(recs)
    codec = codec_for_bytes(seq)
    counter = KmerCounter(k, codec)
    assert counter._keyspace() <= MXU_MAX_BINS

    src = NumpySource(seq, rec, codec)
    [dense] = counter.dispatch_packed_segments([src], min_count,
                                               engine="dense")
    src2 = NumpySource(seq, rec, codec)
    [srt] = counter.dispatch_packed_segments([src2], min_count,
                                             engine="sort")
    td, ts = dense.table(), srt.table()
    np.testing.assert_array_equal(td.kmers, ts.kmers)
    np.testing.assert_array_equal(td.counts, ts.counts)
    assert td.to_dict() == naive_kmers(recs, k, min_count=min_count)


def test_dense_multi_file_per_file_filter():
    rng = random.Random(99)
    groups = [
        _records(rng, 10, "ACGT"),
        _records(rng, 2, "ACGT", lo=0, hi=3),  # shorter than k
        _records(rng, 6, "ACGT"),
    ]
    seqs = [_seq_rec(g) for g in groups]
    codec = codec_for_bytes(np.concatenate([s for s, _ in seqs]))
    counter = KmerCounter(5, codec)
    srcs = [NumpySource(s, r, codec) for s, r in seqs]
    pendings = counter.dispatch_packed_segments(srcs, min_count=2,
                                                engine="dense")
    for g, p in zip(groups, pendings):
        assert p.table().to_dict() == naive_kmers(g, 5, min_count=2)


def test_auto_routes_small_keyspace_dense():
    from mercat2_tpu.engine.counter import _PendingDenseSegments

    rng = random.Random(3)
    recs = _records(rng, 5, "ACGT")
    seq, rec = _seq_rec(recs)
    codec = codec_for_bytes(seq)
    small = KmerCounter(5, codec).dispatch_packed_segments(
        [NumpySource(seq, rec, codec)], 1
    )
    assert isinstance(small[0]._multi, _PendingDenseSegments)
    big = KmerCounter(21, codec).dispatch_packed_segments(
        [NumpySource(seq, rec, codec)], 1
    )
    assert not isinstance(big[0]._multi, _PendingDenseSegments)
