"""The XLA key build, finalize and compaction of the sort path vs numpy.

Each window's key is computed here from its symbol codes with Python
integers, independently of the unpack + pack key build and of the
run-length finalize under test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mercat2_tpu.ops.finalize import (
    _select_first_positions, _sort_and_finalize, build_keyed_words,
    finalize_sorted, packed_payload_words, window_file_ids,
)
from mercat2_tpu.ops.kmer_pack import key_words_for

_ONES = np.uint32(0xFFFFFFFF)

#: (k, bits, symbols): k=16 at 2 bits fills its word and takes the
#: tie-break word; k=31 spans two words; 4-bit codes tile a word too
SHAPES = [
    (21, 2, 50000),
    (16, 2, 20000),
    (5, 2, 4000),
    (31, 2, 40000),
    (7, 4, 9000),
]


def _packed(codes: np.ndarray, bits: int) -> np.ndarray:
    """Big-endian host packing of symbol codes (the transport layout)."""
    per = 32 // bits
    shifts = (32 - bits * (np.arange(per) + 1)).astype(np.uint32)
    return np.bitwise_or.reduce(
        codes.reshape(-1, per).astype(np.uint32) << shifts, axis=1)


def _oracle_words(codes: np.ndarray, k: int, bits: int) -> np.ndarray:
    """uint32[p, payload] key words of every window, from Python ints."""
    payload = max(1, -(-(k * bits) // 32))
    p = codes.shape[0] - k + 1
    out = np.empty((p, payload), np.uint32)
    for i in range(p):
        key = 0
        for c in codes[i : i + k]:
            key = (key << bits) | int(c)
        for w in range(payload):
            out[i, w] = (key >> (32 * (payload - 1 - w))) & 0xFFFFFFFF
    return out


def _case(k: int, bits: int, n: int, seed: int):
    """(codes, valid) with repeats, so that runs of length > 1 exist."""
    rng = np.random.default_rng(seed)
    per = 32 // bits
    n = -(-n // per) * per
    block = rng.integers(0, 1 << bits, size=max(64, n // 8))
    codes = np.resize(block, n).astype(np.uint32)
    codes[n // 2 :] = rng.integers(0, 1 << bits, size=n - n // 2)
    valid = rng.random(n - k + 1) < 0.9
    return codes, valid


@pytest.mark.parametrize("k,bits,n", SHAPES)
def test_key_build_matches_oracle(k, bits, n):
    """Funnel-shift payload + validity mask (+ tie-break word) == keys
    computed symbol by symbol."""
    codes, valid = _case(k, bits, n, seed=k * 100 + bits)
    packed = jnp.asarray(_packed(codes, bits))
    payload = packed_payload_words(packed, k, bits, codes.shape[0])
    keyed, strip = build_keyed_words(payload, jnp.asarray(valid), None, k,
                                     bits, 1)
    want = _oracle_words(codes, k, bits)
    total, tiebreak = key_words_for(k, bits)
    assert len(keyed) == total and strip == int(tiebreak)
    for w in range(want.shape[1]):
        exp = np.where(valid, want[:, w], _ONES)
        np.testing.assert_array_equal(np.asarray(keyed[w]), exp)
    if tiebreak:
        np.testing.assert_array_equal(
            np.asarray(keyed[-1]), np.where(valid, 0, _ONES).astype(np.uint32))


def _oracle_table(codes, valid, k, bits, min_count):
    """Sorted (payload words, counts) of the valid windows with count >=
    min_count, by np.unique over the oracle keys."""
    words = _oracle_words(codes, k, bits)[valid]
    if not words.shape[0]:
        return words, np.zeros(0, np.int64)
    uniq, counts = np.unique(words, axis=0, return_counts=True)
    keep = counts >= min_count
    return uniq[keep], counts[keep]


@pytest.mark.parametrize("k,bits,n", SHAPES)
def test_finalize_sorted_matches_oracle(k, bits, n):
    """Generic multi-word finalize over numpy-sorted key columns."""
    codes, valid = _case(k, bits, n, seed=k * 7 + bits)
    want_w, want_c = _oracle_table(codes, valid, k, bits, 2)
    words = _oracle_words(codes, k, bits)[valid]
    order = np.lexsort(words.T[::-1])
    pad = codes.shape[0] - k + 1 - words.shape[0]
    cols = tuple(
        jnp.asarray(np.concatenate([words[order, w],
                                    np.full(pad, _ONES, np.uint32)]))
        for w in range(words.shape[1]))
    cap = 4096
    got_w, got_c, got_n = finalize_sorted(
        cols, jnp.int32(words.shape[0]), jnp.int32(2), cap)
    assert int(got_n) == want_c.size
    m = min(cap, want_c.size)
    for w in range(words.shape[1]):
        np.testing.assert_array_equal(np.asarray(got_w[w])[:m], want_w[:m, w])
    np.testing.assert_array_equal(np.asarray(got_c)[:m], want_c[:m])


@pytest.mark.parametrize("k,bits,n", SHAPES)
def test_sort_and_finalize_matches_oracle(k, bits, n):
    """Key build -> sort -> finalize as the count programs run it: 2-word
    keys (k=16 with its tie-break word, k=21, k=31) take the fused u64
    sort and the u64 finalize, 1-word keys the generic path."""
    codes, valid = _case(k, bits, n, seed=k * 13 + bits)
    want_w, want_c = _oracle_table(codes, valid, k, bits, 3)

    @jax.jit
    def run(packed, valid):
        payload = packed_payload_words(packed, k, bits, codes.shape[0])
        keyed, strip = build_keyed_words(payload, valid, None, k, bits, 1)
        return _sort_and_finalize(keyed, jnp.sum(valid, dtype=jnp.int32),
                                  jnp.int32(3), 8192, strip)

    got_w, got_c, got_n = run(jnp.asarray(_packed(codes, bits)),
                              jnp.asarray(valid))
    assert int(got_n) == want_c.size
    m = want_c.size
    assert len(got_w) == want_w.shape[1]
    for w in range(want_w.shape[1]):
        np.testing.assert_array_equal(np.asarray(got_w[w])[:m], want_w[:, w])
    np.testing.assert_array_equal(np.asarray(got_c)[:m], want_c)


def test_finalize_run_spanning_many_blocks():
    """One run far longer than any block or tile size is counted exactly."""
    p = 3 * (1 << 14)
    n_valid = p - 5
    col = np.full(p, 7, np.uint32)
    col[n_valid:] = _ONES
    got_w, got_c, got_n = finalize_sorted(
        (jnp.asarray(col),), jnp.int32(n_valid), jnp.int32(2), 16)
    assert int(got_n) == 1
    assert int(np.asarray(got_w[0])[0]) == 7
    assert int(np.asarray(got_c)[0]) == n_valid


def test_finalize_overflow_reports_n_out():
    """More survivors than the cap: n_out says so, and the first cap rows
    are still the lexicographically first ones."""
    p = 4096
    col = np.arange(p, dtype=np.uint32) // 2  # 2048 runs of length 2
    got_w, got_c, got_n = finalize_sorted(
        (jnp.asarray(col),), jnp.int32(p), jnp.int32(2), 64)
    assert int(got_n) == 2048
    np.testing.assert_array_equal(np.asarray(got_w[0]), np.arange(64))
    assert np.all(np.asarray(got_c) == 2)


@pytest.mark.parametrize("density,cap", [(0.001, 64), (0.3, 64), (0.0, 16),
                                         (1.0, 4096)])
def test_compaction_selects_first_positions(density, cap):
    """Ascending positions of the first cap survivors, filler p after."""
    rng = np.random.default_rng(int(density * 1000) + cap)
    p = 50000
    keep = rng.random(p) < density
    got = np.asarray(_select_first_positions(jnp.asarray(keep), p, cap))
    want = np.flatnonzero(keep)[:cap]
    np.testing.assert_array_equal(got[: want.size], want)
    assert np.all(got[want.size :] == p)


def test_compaction_beyond_float32_exact_range():
    """Survivors past position 2**24 keep their exact int32 positions."""
    p = (1 << 24) + 4096
    at = np.array([3, (1 << 24) - 1, 1 << 24, (1 << 24) + 7,
                   (1 << 24) + 4095])
    keep = np.zeros(p, bool)
    keep[at] = True
    got = np.asarray(_select_first_positions(jnp.asarray(keep), p, 8))
    np.testing.assert_array_equal(got[:5], at)
    assert np.all(got[5:] == p)


@pytest.mark.parametrize("n_files", [1, 32, 64, 65, 300])
def test_window_file_ids(n_files):
    """Each window's file id equals numpy's search, on both sides of the
    table length where the compare-all search gives way to the binary
    search."""
    rng = np.random.default_rng(n_files)
    p = 20000
    starts = np.sort(rng.choice(np.arange(1, p), n_files - 1, replace=False))
    starts = np.concatenate([[0], starts]).astype(np.int32)
    got = np.asarray(jax.jit(window_file_ids, static_argnums=1)(
        jnp.asarray(starts), p))
    want = np.searchsorted(starts, np.arange(p), side="right") - 1
    np.testing.assert_array_equal(got, want.astype(np.uint32))
