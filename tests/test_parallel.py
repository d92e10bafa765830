"""Multi-chip sharded counting vs the single-device engine.

Runs on 8 virtual CPU devices (tests/conftest.py). Covers the device mapping
of the reference's chunk-level data parallelism + driver dict merge
(/root/reference/bin/mercat2.py:118-127): haloed stream sharding, dense
psum_scatter/psum histogram reduction, and the distributed sort-count
(splitter partition + all_to_all + on-device RLE/min-count/compaction),
asserting full KmerTable equality against the single-chip engine.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mercat2_tpu.engine.codec import Codec, codec_for_alphabet
from mercat2_tpu.engine.counter import KmerCounter
from mercat2_tpu.ops.dense_hist import dense_kmer_histogram
from mercat2_tpu.parallel import (
    flat_mesh,
    make_mesh,
    mesh_shape_for,
    shard_stream,
    sharded_count_streams,
    sharded_dense_histogram,
)


def _random_stream(n, alphabet, seed, sep_every=None):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, alphabet, size=n, dtype=np.uint8)
    if sep_every:
        s[::sep_every] = alphabet  # sprinkle separators (values >= alphabet)
    return s


def _codec(alphabet: int) -> Codec:
    return codec_for_alphabet(np.arange(65, 65 + alphabet, dtype=np.uint8))


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_mesh_shape_for():
    assert mesh_shape_for(1) == (1, 1)
    assert mesh_shape_for(2) == (2, 1)
    assert mesh_shape_for(8) == (4, 2)
    assert mesh_shape_for(8, bins_parallel=1) == (8, 1)
    with pytest.raises(ValueError):
        mesh_shape_for(6, bins_parallel=4)


def test_shard_stream_covers_every_window():
    k, n_shards = 5, 8
    s = _random_stream(1000, 4, 0)
    shards = shard_stream(s, k, n_shards, sentinel=4)
    L = shards.shape[1] - (k - 1)
    # every global window start appears in exactly one shard, with its full
    # k-symbol window intact thanks to the halo
    rebuilt = []
    for d in range(n_shards):
        for i in range(L):
            g = d * L + i
            if g <= s.shape[0] - k:
                np.testing.assert_array_equal(shards[d, i : i + k], s[g : g + k])
                rebuilt.append(g)
    assert rebuilt == list(range(s.shape[0] - k + 1))


@pytest.mark.parametrize("k,alphabet", [(3, 4), (5, 4), (3, 25)])
def test_sharded_dense_matches_single_device(k, alphabet):
    mesh = make_mesh(8)
    s = _random_stream(4096, alphabet, 1, sep_every=97)
    shards = shard_stream(s, k, mesh.size, sentinel=alphabet)
    hist = sharded_dense_histogram(shards, k=k, alphabet_size=alphabet, mesh=mesh)
    ref = np.asarray(
        dense_kmer_histogram(jnp.asarray(s), k=k, alphabet_size=alphabet)
    )
    np.testing.assert_array_equal(hist, ref.astype(np.int64))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize(
    "k,alphabet,min_count", [(21, 4, 1), (16, 4, 2), (3, 25, 3), (5, 4, 4)]
)
def test_sharded_count_single_file_matches_engine(n_dev, k, alphabet, min_count):
    """Full-table equality (keys AND counts, incl. min-count) per mesh size."""
    codec = _codec(alphabet)
    counter = KmerCounter(k, codec)
    s = _random_stream(5000, alphabet, 10 + k, sep_every=113)
    want = counter.count_stream(s.copy(), min_count)
    got = sharded_count_streams(
        counter, [s.copy()], min_count, flat_mesh(n_dev)
    )
    assert len(got) == 1
    _assert_tables_equal(got[0], want)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_count_multi_file_per_file_filter(n_dev):
    """fid-tagged multi-file launch: per-file tables with per-file
    min-count semantics (ref /root/reference/lib/mercat2_kmers.py:73-76)."""
    k, alphabet, min_count = 9, 4, 2
    codec = _codec(alphabet)
    counter = KmerCounter(k, codec)
    streams = [
        _random_stream(3000, alphabet, 7, sep_every=101),
        _random_stream(1200, alphabet, 8),
        _random_stream(600, alphabet, 9, sep_every=53),
    ]
    want = [counter.count_stream(s.copy(), min_count) for s in streams]
    got = sharded_count_streams(
        counter, [s.copy() for s in streams], min_count, flat_mesh(n_dev)
    )
    for g, w in zip(got, want):
        _assert_tables_equal(g, w)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("k", [17, 18])
def test_sharded_count_low_entropy_word0_no_skew(n_dev, k):
    """k=17/18 nt: sort-key word 0 carries only 2/4 significant bits. The
    fused (word0, word1) splitter key must still partition uniform data
    evenly — table equality AND zero routing-capacity retries."""
    codec = _codec(4)
    counter = KmerCounter(k, codec)
    s = _random_stream(20000, 4, 40 + k, sep_every=211)
    want = counter.count_stream(s.copy(), 1)
    stats: dict = {}
    got = sharded_count_streams(
        counter, [s.copy()], 1, flat_mesh(n_dev), stats=stats
    )
    _assert_tables_equal(got[0], want)
    assert stats["skew_retries"] == 0, stats


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_count_word_fid_mode_no_skew(n_dev):
    """k=16 multi-file puts the FILE ID in sort-key word 0 ("word" fid
    mode): without word-1 fusion the partition degenerates to per-file
    placement. Assert per-file tables AND no seg_cap retry."""
    k, min_count = 16, 2
    codec = _codec(4)
    counter = KmerCounter(k, codec)
    streams = [
        _random_stream(9000, 4, 61, sep_every=173),
        _random_stream(7000, 4, 62),
        _random_stream(5000, 4, 63, sep_every=97),
    ]
    want = [counter.count_stream(s.copy(), min_count) for s in streams]
    stats: dict = {}
    got = sharded_count_streams(
        counter, [s.copy() for s in streams], min_count, flat_mesh(n_dev),
        stats=stats,
    )
    for g, w in zip(got, want):
        _assert_tables_equal(g, w)
    assert stats["skew_retries"] == 0, stats


def _sources(counter, specs):
    """NumpySource list from (n, seed, rec_every) specs (record boundaries
    every ``rec_every`` symbols when set)."""
    from mercat2_tpu.engine.counter import NumpySource

    out = []
    for n, seed, rec_every in specs:
        rng = np.random.default_rng(seed)
        seq = rng.integers(65, 65 + counter.codec.size, size=n, dtype=np.uint8)
        seq = counter.codec.symbols[
            rng.integers(0, counter.codec.size, size=n)
        ]
        rec = (np.arange(n) // rec_every if rec_every else np.zeros(n)).astype(
            np.int64
        )
        out.append((seq, rec, NumpySource(seq, rec, counter.codec)))
    return out


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k,alphabet,min_count", [(3, 25, 2), (4, 25, 1)])
def test_sharded_count_sources_protein_5bit(n_dev, k, alphabet, min_count):
    """5-bit (non-dividing) packed transport through the mesh path."""
    from mercat2_tpu.parallel import sharded_count_sources

    codec = _codec(alphabet)
    counter = KmerCounter(k, codec)
    assert codec.bits == 5 and counter.packable()
    [(seq, rec, src)] = _sources(counter, [(15000, 90 + k, 253)])
    want = counter.count(seq, rec, min_count)
    got = sharded_count_sources(counter, [src], min_count, flat_mesh(n_dev))
    _assert_tables_equal(got[0], want)


@pytest.mark.parametrize("n_dev", [2, 8])
@pytest.mark.parametrize("k,min_count", [(21, 1), (16, 2), (5, 3)])
def test_sharded_count_sources_single_file(n_dev, k, min_count):
    """Packed-transport mesh path vs the single-chip engine (one file,
    record gaps exercised through out-of-band gap ranges)."""
    from mercat2_tpu.parallel import sharded_count_sources

    codec = _codec(4)
    counter = KmerCounter(k, codec)
    [(seq, rec, src)] = _sources(counter, [(30000, 5 + k, 307)])
    want = counter.count(seq, rec, min_count)
    stats: dict = {}
    got = sharded_count_sources(
        counter, [src], min_count, flat_mesh(n_dev), stats=stats
    )
    assert len(got) == 1
    _assert_tables_equal(got[0], want)
    assert stats["skew_retries"] == 0, stats


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_count_sources_multi_file(n_dev):
    """Per-file min-count semantics through the packed mesh path
    (ref /root/reference/lib/mercat2_kmers.py:73-76), including an
    empty file and one shorter than k."""
    from mercat2_tpu.parallel import sharded_count_sources

    k, min_count = 9, 2
    codec = _codec(4)
    counter = KmerCounter(k, codec)
    triples = _sources(
        counter, [(9000, 71, 401), (0, 72, 0), (5, 73, 0), (4000, 74, 0)]
    )
    want = [counter.count(seq, rec, min_count) for seq, rec, _ in triples]
    got = sharded_count_sources(
        counter, [s for _, _, s in triples], min_count, flat_mesh(n_dev)
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_tables_equal(g, w)


def test_sharded_count_extreme_skew_retries():
    """A stream of one repeated symbol puts every window in one key run on
    one device; the routing-capacity retry must still produce exact counts."""
    k, alphabet = 4, 4
    codec = _codec(alphabet)
    counter = KmerCounter(k, codec)
    s = np.zeros(4000, np.uint8)  # 'AAAA' * 1000 -> one kmer, count 3997
    want = counter.count_stream(s.copy(), 1)
    got = sharded_count_streams(counter, [s.copy()], 1, flat_mesh(8))
    _assert_tables_equal(got[0], want)


def test_sharded_count_empty_and_short_streams():
    codec = _codec(4)
    counter = KmerCounter(8, codec)
    streams = [
        np.zeros(0, np.uint8),
        np.full(3, codec.sentinel, np.uint8),  # shorter than k after trim
        _random_stream(500, 4, 11),
    ]
    got = sharded_count_streams(counter, streams, 1, flat_mesh(4))
    assert len(got[0]) == 0 and len(got[1]) == 0
    want = counter.count_stream(streams[2].copy(), 1)
    _assert_tables_equal(got[2], want)


def test_sharded_count_on_real_genome_slice():
    """Sanity on genuine FASTA-derived codes: DJ head vs single-chip."""
    from pathlib import Path

    from mercat2_tpu.engine.codec import codec_for_alphabet
    from mercat2_tpu.io.fasta import parse_fasta_seq

    path = Path("/root/reference/data/5-genomes-fna_gz/DJ.fna.gz")
    if not path.exists():
        pytest.skip("reference data missing")
    seq, rec = parse_fasta_seq(path)
    seq, rec = seq[:200_000], rec[:200_000]
    codec = codec_for_alphabet(np.unique(seq))
    counter = KmerCounter(21, codec)
    stream = counter.build_stream(seq, rec)
    want = counter.count_stream(stream.copy(), 2)
    got = sharded_count_streams(counter, [stream.copy()], 2, flat_mesh(8))
    _assert_tables_equal(got[0], want)


def test_sharded_dense_on_small_mesh():
    mesh = make_mesh(2)
    s = _random_stream(512, 4, 3)
    shards = shard_stream(s, 4, mesh.size, sentinel=4)
    hist = sharded_dense_histogram(shards, k=4, alphabet_size=4, mesh=mesh)
    assert int(hist.sum()) == s.shape[0] - 4 + 1


def test_route_hbm_budget_batches():
    """sharded_count_sources splits launches to the per-device routing
    budget, keeps files whole, and stays exact."""
    from mercat2_tpu.engine.counter import NumpySource
    from mercat2_tpu.parallel.count import sharded_count_sources

    codec = codec_for_alphabet(np.arange(65, 69, dtype=np.uint8))
    counter = KmerCounter(21, codec)
    rng = np.random.default_rng(9)
    seqs = [codec.symbols[rng.integers(0, 4, size=20_000)] for _ in range(6)]
    recs = [(np.arange(s.shape[0]) // 5_000).astype(np.int64) for s in seqs]
    want = [counter.count(s.copy(), r, 1) for s, r in zip(seqs, recs)]

    stats: dict = {}
    got = sharded_count_sources(
        counter,
        [NumpySource(s, r, codec) for s, r in zip(seqs, recs)],
        1, flat_mesh(4),
        hbm_budget=1 << 20,   # 1 MB: forces several batches
        stats=stats,
    )
    assert stats.get("route_batches", 1) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.kmers, w.kmers)
        np.testing.assert_array_equal(g.counts, w.counts)

    # a single file larger than the per-batch bound still launches whole
    stats2: dict = {}
    [g1] = sharded_count_sources(
        counter, [NumpySource(seqs[0], recs[0], codec)], 1, flat_mesh(4),
        hbm_budget=1 << 16, stats=stats2,
    )
    np.testing.assert_array_equal(g1.kmers, want[0].kmers)
    assert "route_batches" not in stats2
