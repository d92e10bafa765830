"""Device-side k-mer extraction: rolling multiword bit-pack + lexicographic sort.

This replaces the reference's Python dict hot loop
(/root/reference/lib/mercat2_kmers.py:56-69) with a device pipeline:

    uint8 code stream (separator-delimited records, sentinel-padded)
      -> rolling b-bit pack into ceil(k*b/32) uint32 key words per window
      -> window validity mask (no window may contain a record separator,
         mirroring the reference's per-record ``seq`` reset at
         /root/reference/lib/mercat2_kmers.py:52-61)
      -> invalid windows forced to the all-ones key
      -> multi-key ``lax.sort`` (lexicographic over the key words)

The sorted key stream is then run-length encoded (on host for now; see
``mercat2_tpu.engine.counter``) to produce (kmer, count) pairs already in
the reference's output order, because codes are assigned in ascending byte
order (see ``mercat2_tpu.engine.codec``).

Everything here is static-shape and jit-friendly: ``k``, ``bits`` and the
word count are Python-level constants baked into the compiled kernel; the
stream length is padded to a size bucket by the caller.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["pack_kmer_words", "window_validity", "sorted_kmer_keys", "key_words_for"]

_ONES32 = jnp.uint32(0xFFFFFFFF)


def key_words_for(k: int, bits: int) -> tuple[int, bool]:
    """(total sort-key words, has_tiebreak_word).

    The payload is ``ceil(k*bits/32)`` words. When ``k*bits`` exactly fills
    the payload, an extra tie-break word (0 = valid, ~0 = invalid) is
    appended so the all-ones invalid marker cannot collide with a real key
    (e.g. ``T``*16 under 2-bit DNA).
    """
    payload = max(1, -(-(k * bits) // 32))
    tiebreak = k * bits == 32 * payload
    return payload + int(tiebreak), tiebreak


def pack_kmer_words(codes: jax.Array, k: int, bits: int) -> list[jax.Array]:
    """Rolling pack: for each window start i, big-endian pack codes[i:i+k].

    Args:
        codes: uint32[N] symbol codes (values at separator positions are
            arbitrary; they get masked to ``bits`` bits and discarded by the
            validity mask downstream).
        k: window length (static).
        bits: bits per symbol (static, 1..8).

    Returns:
        List of ``payload`` uint32[N-k+1] words, most-significant first.
        Symbol 0 of the window occupies the most-significant bits, so
        numeric order of the word tuple == lexicographic order of windows.
    """
    if 32 % bits == 0:
        return _pack_kmer_words_tree(codes, k, bits)
    return _pack_kmer_words_serial(codes, k, bits)


def _pack_kmer_words_serial(codes: jax.Array, k: int, bits: int) -> list[jax.Array]:
    """k-step shift-OR chain; handles symbols split across word boundaries
    (bits not dividing 32, e.g. 5-bit protein codes)."""
    n = codes.shape[0]
    p = n - k + 1
    payload = max(1, -(-(k * bits) // 32))
    mask_b = jnp.uint32((1 << bits) - 1)

    words = [jnp.zeros((p,), jnp.uint32) for _ in range(payload)]
    for j in range(k):
        c = jax.lax.slice_in_dim(codes, j, j + p) & mask_b
        if payload == 1:
            words[0] = (words[0] << bits) | c
        else:
            shifted = [
                (words[w] << bits) | (words[w + 1] >> (32 - bits))
                for w in range(payload - 1)
            ]
            shifted.append((words[payload - 1] << bits) | c)
            words = shifted
    return words


def _pack_kmer_words_tree(codes: jax.Array, k: int, bits: int) -> list[jax.Array]:
    """Log-tree pack for word-aligned symbol widths (bits | 32).

    Precompute P_m[i] = codes[i:i+m) packed into the low m*bits bits for
    m = 1, 2, 4, ... (while m*bits <= 32), then compose each output word's
    symbol range from its binary decomposition — O(log k) elementwise
    passes instead of the k-step serial chain.
    """
    n = codes.shape[0]
    p = n - k + 1
    payload = max(1, -(-(k * bits) // 32))
    mask_b = jnp.uint32((1 << bits) - 1)
    per = 32 // bits

    pows = [codes & mask_b]  # P_1 over the full stream
    m = 1
    while 2 * m <= per:
        pm = pows[-1]
        avail = pm.shape[0] - m  # P_{2m} has this many entries
        pows.append(
            (jax.lax.slice_in_dim(pm, 0, avail) << jnp.uint32(m * bits))
            | jax.lax.slice_in_dim(pm, m, m + avail)
        )
        m *= 2

    def pack_range(a: int, s: int) -> jax.Array:
        """Pack of codes[i+a : i+a+s) (s*bits <= 32) for every window i."""
        acc = None
        off = a
        rem = s
        for j in range(len(pows) - 1, -1, -1):
            mj = 1 << j
            if rem >= mj:
                part = jax.lax.slice_in_dim(pows[j], off, off + p)
                acc = part if acc is None else (
                    (acc << jnp.uint32(mj * bits)) | part
                )
                off += mj
                rem -= mj
        assert rem == 0
        return acc

    kb0 = k * bits - 32 * (payload - 1)  # bits used in word 0
    s0 = kb0 // bits                     # symbols in word 0
    words = [pack_range(0, s0)]
    a = s0
    for _ in range(payload - 1):
        words.append(pack_range(a, per))
        a += per
    return words


def window_validity(codes_u8: jax.Array, k: int, alphabet_size: int) -> jax.Array:
    """bool[N-k+1]: True where codes[i:i+k] contains no separator/pad.

    Separators are stored out-of-band as values ``>= alphabet_size`` in the
    uint8 stream (see codec docs).
    """
    n = codes_u8.shape[0]
    p = n - k + 1
    sep = (codes_u8 >= jnp.uint8(alphabet_size)).astype(jnp.int32)
    ecs = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(sep)])
    return (ecs[k : k + p] - ecs[:p]) == 0


@functools.partial(jax.jit, static_argnames=("k", "bits", "alphabet_size"))
def sorted_kmer_keys(codes_u8: jax.Array, *, k: int, bits: int, alphabet_size: int):
    """Full device pipeline: codes -> sorted key words + valid-window count.

    Args:
        codes_u8: uint8[N] stream; symbol codes in [0, alphabet_size),
            separators/padding >= alphabet_size. N is the padded bucket size.

    Returns:
        (words, n_valid): ``words`` is a tuple of uint32[N-k+1] sorted
        lexicographically (invalid windows hold the all-ones key and sort
        last); ``n_valid`` is the int32 count of valid windows, i.e. the
        prefix of ``words`` holding real k-mers.
    """
    valid = window_validity(codes_u8, k, alphabet_size)
    payload = pack_kmer_words(codes_u8.astype(jnp.uint32), k, bits)
    total_words, tiebreak = key_words_for(k, bits)

    keyed = [jnp.where(valid, w, _ONES32) for w in payload]
    if tiebreak:
        keyed.append(jnp.where(valid, jnp.uint32(0), _ONES32))
    assert len(keyed) == total_words

    sorted_words = jax.lax.sort(tuple(keyed), num_keys=total_words)
    n_valid = jnp.sum(valid, dtype=jnp.int32)
    return sorted_words, n_valid
