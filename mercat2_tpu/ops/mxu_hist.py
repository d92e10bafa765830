"""Dense k-mer histogram from one-hot matmuls instead of sort or scatter.

For small keyspaces (B = S**k <= ~16K bins) the count table is a dense
histogram, built here on the matrix units: split each window's bin index
into (hi, lo) = (idx // B2, idx % B2) and accumulate
``one_hot(hi)^T @ one_hot(lo)`` over chunks — every (hi, lo) pair's dot
product counts its occurrences. Used for nucleotide k <= 7 and other
keyspaces up to MXU_MAX_BINS. Whether a scatter-add or segment-sum
histogram is faster on the H100 is not measured.

Exactness: chunk size C < 2**24 keeps every per-chunk count exactly
representable in the bf16-input/f32-accumulate matmul; chunks accumulate
in int32. Bin index == base-S big-endian window value, so bin order ==
lexicographic k-mer order and the host decode is trivial
(reference output order: /root/reference/bin/mercat2.py:132).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mercat2_tpu.ops.finalize import packed_window_validity, unpack_codes

__all__ = [
    "MXU_MAX_BINS", "mxu_split", "mxu_hist_from_idx",
    "count_kmers_dense_segments", "decode_dense_histogram",
]

#: largest keyspace routed to the one-hot histogram; the padded one-hot
#: FLOPs (2 * windows * B1p * B2p) grow with it. Not measured on the H100.
MXU_MAX_BINS = 1 << 14

#: windows per matmul chunk: keeps the one-hot operands small and every
#: per-chunk count below 2**24, so the f32 accumulation is exact. Not
#: measured on the H100.
_CHUNK = 1 << 13


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def mxu_split(k: int, alphabet_size: int) -> tuple[int, int]:
    """(B1, B2) = (S**k1, S**k2) minimizing padded matmul work.

    The one-hot operands pad their lane dims to 128, so the cost metric is
    pad128(B1) * pad128(B2); ties prefer the more balanced split.
    """
    best = None
    for k1 in range(0, k + 1):
        b1 = alphabet_size**k1
        b2 = alphabet_size ** (k - k1)
        cost = _pad_to(b1, 128) * _pad_to(b2, 128)
        key = (cost, abs(k1 - (k - k1)))
        if best is None or key < best[0]:
            best = (key, (b1, b2))
    return best[1]


def mxu_hist_from_idx(idx: jax.Array, b1: int, b2: int) -> jax.Array:
    """int32[P] bin indices (invalid < 0) -> int32[b1*b2] histogram.

    ``idx`` must be in [0, b1*b2) where valid; negative rows match no
    one-hot column (floor division keeps hi negative) and count nowhere.
    """
    p = idx.shape[0]
    b1p = _pad_to(b1, 128)
    b2p = _pad_to(b2, 128)
    nc = max(1, -(-p // _CHUNK))
    pad = nc * _CHUNK - p
    idx = jnp.concatenate([idx, jnp.full((pad,), -1, jnp.int32)])
    chunks = idx.reshape(nc, _CHUNK)
    iota1 = jax.lax.broadcasted_iota(jnp.int32, (1, b1p), 1)
    iota2 = jax.lax.broadcasted_iota(jnp.int32, (1, b2p), 1)

    def body(acc, ch):
        hi = ch // b2  # invalid stays negative: matches no column
        lo = ch % b2   # python-style mod >= 0; hi alone kills the row
        a = (hi[:, None] == iota1).astype(jnp.bfloat16)
        b = (lo[:, None] == iota2).astype(jnp.bfloat16)
        h = jax.lax.dot_general(
            a, b, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return acc + h.astype(jnp.int32), None

    acc = jax.lax.scan(
        body, jnp.zeros((b1p, b2p), jnp.int32), chunks
    )[0]
    return acc[:b1, :b2].reshape(-1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "bits", "alphabet_size", "seg_words"),
)
def count_kmers_dense_segments(
    packed: jax.Array,
    gap_begin: jax.Array,
    gap_end: jax.Array,
    *,
    k: int,
    bits: int,
    alphabet_size: int,
    seg_words: tuple,
):
    """Per-file dense histograms of one packed launch group, ONE program.

    Same transport and segment layout as
    ops.finalize.count_kmers_packed_segments (word ranges per file, global
    gap ranges), but each file's windows are binned by one-hot matmuls
    instead of sorted. Returns one int32[S**k] histogram per file; the host applies
    the per-file min-count filter (/root/reference/lib/mercat2_kmers.py:73-76)
    and decodes nonzero bins, which arrive already in lexicographic order.
    """
    per = 32 // bits
    s = jnp.int32(alphabet_size)
    b1, b2 = mxu_split(k, alphabet_size)
    out = []
    for (w0, w1) in seg_words:
        n_sym = (w1 - w0) * per
        codes = unpack_codes(
            jax.lax.slice_in_dim(packed, w0, w1), bits, n_sym
        ).astype(jnp.int32)
        p = n_sym - k + 1
        s0 = w0 * per
        valid = packed_window_validity(
            gap_begin - jnp.int32(s0), gap_end - jnp.int32(s0), k, p
        )
        idx = jnp.zeros((p,), jnp.int32)
        for j in range(k):
            c = jax.lax.slice_in_dim(codes, j, j + p)
            idx = idx * s + jnp.minimum(c, s - 1)
        idx = jnp.where(valid, idx, -1)
        out.append(mxu_hist_from_idx(idx, b1, b2))
    return tuple(out)


def decode_dense_histogram(hist, k: int, codec, min_count: int):
    """int32[S**k] -> KmerTable (min-count filtered, lexicographic)."""
    import numpy as np

    from mercat2_tpu.engine.counter import KmerTable

    hist = np.asarray(hist)
    bins = np.flatnonzero(hist >= max(1, min_count))
    if bins.size == 0:
        return KmerTable.empty(k)
    s = codec.size
    vals = bins.astype(np.int64)
    kmers = np.empty((bins.size, k), np.uint8)
    for j in range(k - 1, -1, -1):
        kmers[:, j] = codec.symbols[vals % s]
        vals //= s
    return KmerTable(kmers, hist[bins].astype(np.int64))
