"""Fused device-side k-mer count finalization.

The whole reduction runs on device, so only the compacted table crosses
back to the host instead of the full sorted key stream (~12 bytes per
window):

    pack -> multiword sort -> boundary detection -> run lengths (cummin
    scan) -> min-count filter -> compaction (cumsum + scatter + gather)

and returns only the compacted unique (key, count) table, capped at a
static ``cap`` (a few MB instead of tens). ``min_count`` is a traced
scalar so changing it never recompiles; ``cap`` overflow is detected via
the returned ``n_out`` and retried by the caller with a bigger cap.

This replaces the reference's per-file dict + Counter filter
(/root/reference/lib/mercat2_kmers.py:56-76) with an all-device pipeline.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mercat2_tpu.ops.kmer_pack import (
    key_words_for,
    pack_kmer_words,
    window_validity,
)

__all__ = [
    "count_kmers_device", "count_kmers_multi_device", "count_kmers_packed",
    "fid_layout", "unpack_codes", "packed_window_validity",
    "dense_count_device", "build_keyed_words", "finalize_sorted",
    "packed_keyed_words",
]

_ONES32 = jnp.uint32(0xFFFFFFFF)
_I32MAX = jnp.int32(2**31 - 1)


def _sort_fused_u64(keyed: list) -> jax.Array:
    """Fuse a 2-word key column pair into uint64 and sort it.

    Word 0 carries the most-significant key bits in its LOW bits
    (pack_kmer_words layout), so ``(w0 << 32) | w1`` preserves the
    lexicographic order of the (w0, w1) tuple, including the all-ones
    invalid marker (which becomes all-ones u64, still sorting last).
    A single-key sort compiles faster than the two-operand u32 sort, and
    the u64-direct finalize (:func:`_finalize_sorted_u64`) avoids both the
    split pass and the generic run-length chain. Must be traced inside
    ``jax.enable_x64(True)``; only this subsection of the program uses
    64-bit types, all inputs/outputs stay u32/i32.
    """
    x = (keyed[0].astype(jnp.uint64) << jnp.uint64(32)) | keyed[1].astype(
        jnp.uint64
    )
    return jax.lax.sort(x)


def _split_u64(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """uint64 -> (hi u32, lo u32) word columns (inverse of the fuse)."""
    return (
        (x >> jnp.uint64(32)).astype(jnp.uint32),
        (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32),
    )


def _finalize_sorted_u64(s: jax.Array, n_valid, min_count, cap: int):
    """RLE + min-count + compaction over a SORTED uint64 key column.

    Replaces the generic multi-word finalize for the fused-u64 path with a
    cheaper pass structure (no flip/cummin/flip run-length chain):

    - a run survives min_count iff key[i + mc - 1] == key[i] at its start
      boundary — ONE dynamic-shift compare instead of materializing run
      lengths for every row (invalid rows hold the all-ones marker, which
      never equals a valid key, so runs crossing n_valid fail the test
      for free);
    - the surviving runs' END rows satisfy the mirrored test
      key[i - mc + 1] == key[i] at a run end; starts and ends of disjoint
      runs pair up 1:1 in sorted order, so counts = end - start + 1 after
      compacting both position sets (no per-row run lengths, no
      searchsorted).
    """
    p = s.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    in_valid = pos < n_valid
    mc = jnp.asarray(min_count, jnp.int32)
    marker = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    pad = jnp.full((p,), marker, jnp.uint64)

    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), s[1:] != s[:-1]]
    ) & in_valid
    fwd = jax.lax.dynamic_slice(
        jnp.concatenate([s, pad]), (jnp.clip(mc - 1, 0, p),), (p,)
    )
    keep = is_start & (fwd == s)
    n_out = jnp.sum(keep, dtype=jnp.int32)

    is_end = jnp.concatenate(
        [s[:-1] != s[1:], jnp.ones((1,), bool)]
    ) & in_valid
    bwd = jax.lax.dynamic_slice(
        jnp.concatenate([pad, s]), (jnp.clip(p - (mc - 1), 0, p),), (p,)
    )
    end_keep = is_end & (bwd == s)

    kept_pos = _select_first_positions(keep, p, cap)
    end_pos = _select_first_positions(end_keep, p, cap)
    keys = s[jnp.minimum(kept_pos, p - 1)]
    counts = jnp.where(
        kept_pos < p, jnp.minimum(end_pos, p - 1) - kept_pos + 1, 0
    )
    return keys, counts, n_out


def _sort_and_finalize(keyed: list, n_valid, min_count, cap: int,
                       strip_tail: int):
    """Sort key columns and reduce to the compacted table.

    Uses the fused single-u64 sort + u64 finalize for 2-word keys (the
    common DNA k in (16, 32] and protein k in (7, 12] cases), the variadic
    multi-word sort otherwise. Returns (words, counts, n_out) with
    ``strip_tail`` trailing columns dropped from the output words. The x64
    context is scoped to the fuse/sort/finalize subsection so the rest of
    the program traces under default x32 rules; the u64 -> 2 x u32 split
    happens only on the cap-sized output.
    """
    if len(keyed) == 2:
        with jax.enable_x64(True):
            s = _sort_fused_u64(keyed)
            keys, counts, n_out = _finalize_sorted_u64(
                s, n_valid, min_count, cap
            )
            words = _split_u64(keys)
        return words[: 2 - strip_tail], counts, n_out
    words = jax.lax.sort(tuple(keyed), num_keys=len(keyed))
    return _finalize_sorted(
        words[: len(words) - strip_tail], n_valid, min_count, cap
    )


def _select_first_positions(keep: jax.Array, p: int, cap: int) -> jax.Array:
    """int32[cap] ascending positions of the first ``cap`` True entries
    (filler ``p`` at the tail when fewer survive).

    Exact stream compaction: each survivor's rank is an inclusive cumsum,
    and survivors ranked below ``cap`` are scattered to their rank; every
    other row targets the out-of-bounds slot ``cap`` and is dropped.
    """
    pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    rank = jnp.cumsum(keep, dtype=jnp.int32) - 1
    dst = jnp.where(keep & (rank < cap), rank, cap)
    return jnp.full((cap,), p, jnp.int32).at[dst].set(pos, mode="drop")


def _finalize_sorted(words, n_valid, min_count, cap: int):
    """Shared post-sort reduction: RLE over the sorted key words, min-count
    filter, compaction to the first ``cap`` surviving rows.

    ``words`` is the tuple of sorted uint32 key columns (invalid windows
    hold the all-ones key and sort last; ``n_valid`` is their count).
    """
    p = words[0].shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    in_valid = pos < n_valid

    # run boundaries over the sorted keys (first element is a boundary)
    boundary = jnp.zeros((p,), bool).at[0].set(True)
    for w in words:
        boundary = boundary | jnp.concatenate(
            [jnp.ones((1,), bool), w[1:] != w[:-1]]
        )
    boundary = boundary & in_valid

    # run length of the run starting at each boundary = next boundary - pos
    # (next-boundary-position via a reverse cummin over boundary positions)
    bpos = jnp.where(boundary, pos, _I32MAX)
    nxt = jnp.flip(jax.lax.cummin(jnp.flip(bpos)))  # inclusive: >= own pos
    nxt_excl = jnp.concatenate([nxt[1:], jnp.full((1,), _I32MAX, jnp.int32)])
    run_len = jnp.minimum(nxt_excl, n_valid) - pos  # valid at boundaries

    keep = boundary & (run_len >= jnp.asarray(min_count, jnp.int32))
    n_out = jnp.sum(keep, dtype=jnp.int32)

    kept_pos = _select_first_positions(keep, p, cap)
    safe = jnp.minimum(kept_pos, p - 1)
    out_words = tuple(w[safe] for w in words)
    out_counts = jnp.where(kept_pos < p, run_len[safe], 0)
    return out_words, out_counts, n_out


#: public alias (used by the sharded path in mercat2_tpu.parallel.count)
def finalize_sorted(words, n_valid, min_count, cap: int):
    """See :func:`_finalize_sorted`."""
    return _finalize_sorted(words, n_valid, min_count, cap)


def build_keyed_words(payload, valid, fid, k: int, bits: int,
                      n_files: int) -> tuple[list, int]:
    """Masked sort-key columns for a (possibly multi-file) window set.

    Shared by the single-chip kernels and the sharded mesh path. Invalid
    windows get the all-ones key in every word so they sort last; the
    marker never collides with a real key because either (a) word 0 has
    spare bits (fid field or short top word) that are never all-ones for
    valid rows, or (b) an explicit all-zero tie-break word is appended
    (``strip_tail`` = 1) exactly when the payload fills its words
    (key_words_for semantics).

    Args:
        payload: list of uint32[P] packed key words (pack_kmer_words).
        valid: bool[P] window validity.
        fid: uint32[P] per-window file id (required when n_files > 1).
        n_files: number of files sharing the stream.

    Returns:
        (keyed, strip_tail): sort-key columns (all of them are sort keys)
        and how many trailing columns to drop before finalize/decode.
    """
    if n_files == 1:
        _, tiebreak = key_words_for(k, bits)
        keyed = [jnp.where(valid, w, _ONES32) for w in payload]
        if tiebreak:
            keyed.append(jnp.where(valid, jnp.uint32(0), _ONES32))
        return keyed, int(tiebreak)
    mode, shift = fid_layout(k, bits, n_files)
    if mode == "embedded":
        payload = [payload[0] | (fid << shift)] + payload[1:]
        keyed = [jnp.where(valid, w, _ONES32) for w in payload]
    else:
        keyed = [jnp.where(valid, fid, _ONES32)]
        keyed += [jnp.where(valid, w, _ONES32) for w in payload]
    return keyed, 0


def unpack_codes(packed: jax.Array, bits: int, n_sym: int) -> jax.Array:
    """uint32[W] big-endian packed words -> uint32[n_sym] symbol codes.

    Symbol 0 of a word sits in the word's most-significant ``bits`` bits,
    matching the host packers (io.native / engine.counter). ``per = 32 //
    bits`` symbols ride each word (the low ``32 - per*bits`` bits are unused
    when bits does not divide 32, e.g. 5-bit protein codes pack 6/word);
    requires ``n_sym == W * per``.
    """
    per = 32 // bits
    assert packed.shape[0] * per == n_sym, (packed.shape, per, n_sym)
    mask = jnp.uint32((1 << bits) - 1)
    # expand each word to its `per` symbol lanes (broadcast + reshape; no
    # gather), then shift each lane down by its in-word position
    lanes = jnp.broadcast_to(packed[:, None], (packed.shape[0], per))
    shifts = (32 - bits * (jax.lax.broadcasted_iota(
        jnp.uint32, (1, per), 1) + 1)).astype(jnp.uint32)
    return ((lanes >> shifts) & mask).reshape(n_sym)


def packed_window_validity(
    gap_begin: jax.Array, gap_end: jax.Array, k: int, p: int
) -> jax.Array:
    """bool[p]: window validity from half-open gap symbol ranges.

    A window [i, i+k) is invalid iff it intersects any gap range [b, e),
    i.e. i in [b-k+1, e) — the ranges widened left by k-1. Computed with a
    difference array + one cumsum (the packed-transport replacement for the
    sentinel scan in ops.kmer_pack.window_validity). Pad unused entries
    with b == e >= p + k - 1: both edges clamp to p, a no-op.
    """
    b = jnp.clip(gap_begin.astype(jnp.int32) - (k - 1), 0, p)
    e = jnp.clip(gap_end.astype(jnp.int32), 0, p)
    e = jnp.maximum(e, b)
    d = jnp.zeros((p + 1,), jnp.int32)
    d = d.at[b].add(1)
    d = d.at[e].add(-1)
    return jax.lax.cumsum(d[:p]) == 0


def packed_payload_words(packed, k: int, bits: int, n_sym: int) -> list:
    """Payload key words of every window of a packed transport buffer."""
    return pack_kmer_words(unpack_codes(packed, bits, n_sym), k, bits)


#: largest file-start table searched by comparing every window with every
#: start; longer tables take the binary search
_COMPARE_ALL_FILES = 64


def window_file_ids(file_starts, p: int) -> jax.Array:
    """uint32[p]: index of the file each window start falls in.

    A short ``file_starts`` (the uniform path's 32 slots) is searched by
    comparing every window with every start in one fused pass: the
    binary-search loop of the default searchsorted cost several times more
    on the GPU at the uniform launch size. Longer tables, whose compare
    pass grows with the file count, keep the binary search.
    """
    pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    method = ("compare_all" if file_starts.shape[0] <= _COMPARE_ALL_FILES
              else "scan")
    return jnp.searchsorted(
        file_starts, pos, side="right", method=method
    ).astype(jnp.uint32) - 1


def packed_keyed_words(packed, gap_begin, gap_end, file_starts, *, k: int,
                       bits: int, n_files: int, n_sym: int):
    """Masked, fid-tagged sort-key columns of one packed launch group.

    Builds each window's key words from the transport words, derives
    window validity from the gap ranges and tags each window with its file
    id (see :func:`build_keyed_words`). Returns (keyed, n_valid,
    strip_tail) for :func:`_sort_and_finalize`.
    """
    p = n_sym - k + 1
    valid = packed_window_validity(gap_begin, gap_end, k, p)
    payload = packed_payload_words(packed, k, bits, n_sym)
    fid = None
    if n_files > 1:
        fid = window_file_ids(file_starts, p)
    keyed, strip_tail = build_keyed_words(payload, valid, fid, k, bits,
                                          n_files)
    return keyed, jnp.sum(valid, dtype=jnp.int32), strip_tail


@functools.partial(
    jax.jit,
    static_argnames=("k", "bits", "alphabet_size", "cap", "n_files", "n_sym"),
)
def count_kmers_packed(
    packed: jax.Array,
    gap_begin: jax.Array,
    gap_end: jax.Array,
    file_starts: jax.Array,
    min_count: jax.Array,
    *,
    k: int,
    bits: int,
    alphabet_size: int,
    cap: int,
    n_files: int,
    n_sym: int,
):
    """Count k-mers of one launch group from a bit-packed transport buffer.

    The host ships ``bits``-per-symbol packed words — 4x fewer bytes than
    the uint8 code stream for DNA — plus tiny gap-range and file-start
    arrays, and the device unpacks. Record/file separation is out-of-band:
    ``gap_begin/gap_end`` list the symbol ranges (record gaps, inter-file
    alignment gaps, tail padding) that no valid window may intersect; there
    are no sentinel codes in the packed data.

    Otherwise identical semantics to :func:`count_kmers_multi_device`
    (per-file fid-tagged sort keys, per-file min-count, reference semantics
    /root/reference/lib/mercat2_kmers.py:73-76).
    """
    keyed, n_valid, strip_tail = packed_keyed_words(
        packed, gap_begin, gap_end, file_starts,
        k=k, bits=bits, n_files=n_files, n_sym=n_sym,
    )
    return _sort_and_finalize(keyed, n_valid, min_count, cap, strip_tail)


@functools.partial(
    jax.jit,
    static_argnames=("k", "bits", "alphabet_size", "seg_words", "caps"),
)
def count_kmers_packed_segments(
    packed: jax.Array,
    gap_begin: jax.Array,
    gap_end: jax.Array,
    min_count: jax.Array,
    *,
    k: int,
    bits: int,
    alphabet_size: int,
    seg_words: tuple,
    caps: tuple,
):
    """Count EVERY file of a launch group in one program, one sorted-count
    per file segment (no fid tagging, no combined sort).

    ``seg_words`` is a static tuple of (word_start, word_end) packed-word
    ranges, one per file (word-aligned by the host packer); ``caps`` the
    per-file output capacities. Gap ranges are global symbol coordinates
    and are re-based per segment (out-of-segment ranges clamp to no-ops).

    Rationale vs the fid-tagged single sort (count_kmers_packed): B
    shorter sorts instead of one long one, still with one launch and one
    host sync for the whole group. Per-file min-count semantics
    (/root/reference/lib/mercat2_kmers.py:73-76) fall out for free.

    Returns a flat tuple: for each file f, (words_f..., counts_f, n_out_f).
    """
    per = 32 // bits
    out = []
    for (w0, w1), cap in zip(seg_words, caps):
        n_sym = (w1 - w0) * per
        p = n_sym - k + 1
        s0 = w0 * per
        valid = packed_window_validity(
            gap_begin - jnp.int32(s0), gap_end - jnp.int32(s0), k, p
        )
        payload = packed_payload_words(
            jax.lax.slice_in_dim(packed, w0, w1), k, bits, n_sym
        )
        keyed, strip = build_keyed_words(payload, valid, None, k, bits, 1)
        n_valid = jnp.sum(valid, dtype=jnp.int32)
        w, c, n = _sort_and_finalize(keyed, n_valid, min_count, cap, strip)
        out.extend(list(w) + [c, n])
    return tuple(out)



@functools.partial(
    jax.jit, static_argnames=("k", "bits", "alphabet_size", "cap")
)
def count_kmers_device(
    codes_u8: jax.Array,
    min_count: jax.Array,
    *,
    k: int,
    bits: int,
    alphabet_size: int,
    cap: int,
):
    """uint8[N] code stream -> compacted sorted unique-kmer table.

    Args:
        codes_u8: sentinel-delimited padded code stream (see engine.codec).
        min_count: int32 scalar; keep kmers with count >= min_count.
        cap: static output capacity (table rows). If the true number of
            surviving kmers exceeds cap, ``n_out`` reports it and the
            leading cap rows are still the lexicographically first ones.

    Returns:
        (words, counts, n_out):
        words: tuple of uint32[cap] payload columns (big-endian packed,
            lexicographically sorted).
        counts: int32[cap] occurrence counts.
        n_out: int32 -- number of surviving kmers (may exceed cap).
    """
    n = codes_u8.shape[0]
    p = n - k + 1

    valid = window_validity(codes_u8, k, alphabet_size)
    payload = pack_kmer_words(codes_u8.astype(jnp.uint32), k, bits)
    total_words, tiebreak = key_words_for(k, bits)
    keyed = [jnp.where(valid, w, _ONES32) for w in payload]
    if tiebreak:
        keyed.append(jnp.where(valid, jnp.uint32(0), _ONES32))
    n_valid = jnp.sum(valid, dtype=jnp.int32)
    # the tie-break word (when present) is constant over valid rows and
    # dropped from the output
    return _sort_and_finalize(keyed, n_valid, min_count, cap, int(tiebreak))



def fid_layout(k: int, bits: int, n_files: int) -> tuple[str, int]:
    """How to tag each window's sort key with its file id (see
    ``count_kmers_multi_device``).

    Returns ("embedded", shift) when the key's top word has enough spare
    bits to hold the fid for free, else ("word", 0) meaning a dedicated
    leading fid word (which REPLACES the tie-break word when one exists,
    so it is also free in that case).
    """
    fid_bits = max(1, n_files.bit_length())
    payload = max(1, -(-(k * bits) // 32))
    kb0 = k * bits - 32 * (payload - 1)  # key bits living in word0
    if 32 - kb0 >= fid_bits:
        return "embedded", kb0
    return "word", 0


@functools.partial(
    jax.jit, static_argnames=("k", "bits", "alphabet_size", "cap", "n_files")
)
def count_kmers_multi_device(
    codes_u8: jax.Array,
    starts: jax.Array,
    min_count: jax.Array,
    *,
    k: int,
    bits: int,
    alphabet_size: int,
    cap: int,
    n_files: int,
):
    """Count several files in ONE launch via file-id-tagged sort keys.

    ``codes_u8`` is the concatenation of the files' code streams with k-1
    sentinel separators between files (so windows never span files) and
    sentinel tail padding. ``starts`` (int32[n_files]) holds each file's
    first position in the combined stream.

    Each window's sort key is prefixed with its file id — either packed
    into the spare high bits of the top key word (free) or as a dedicated
    leading word (see :func:`fid_layout`). One 1-D sort then groups rows by
    (file, kmer); equal kmers from different files never merge, per-file
    rows come out contiguous and lexicographically sorted, and the host
    splits the compacted table by fid. This replaces B per-file launches
    with one, without the batched-sort deoptimization a vmapped [B, N]
    layout incurs, and keeps the reference's per-file min-count semantics
    (/root/reference/lib/mercat2_kmers.py:73-76) since runs are per-file.

    Returns (words, counts, n_out) like :func:`count_kmers_device`; the
    leading/embedded fid stays in ``words`` for the host to strip.
    """
    n = codes_u8.shape[0]
    p = n - k + 1

    valid = window_validity(codes_u8, k, alphabet_size)
    payload = pack_kmer_words(codes_u8.astype(jnp.uint32), k, bits)
    pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    fid = jnp.searchsorted(starts, pos, side="right").astype(jnp.uint32) - 1

    mode, shift = fid_layout(k, bits, n_files)
    if mode == "embedded":
        payload = [payload[0] | (fid << shift)] + payload[1:]
        keyed = [jnp.where(valid, w, _ONES32) for w in payload]
        # spare bits make the all-ones invalid marker unambiguous: real fids
        # are < 2**fid_bits - 1 <= the marker's fid field
    else:
        keyed = [jnp.where(valid, fid, _ONES32)]
        keyed += [jnp.where(valid, w, _ONES32) for w in payload]

    n_valid = jnp.sum(valid, dtype=jnp.int32)
    return _sort_and_finalize(keyed, n_valid, min_count, cap, 0)



@functools.partial(jax.jit, static_argnames=("k", "alphabet_size"))
def dense_count_device(codes_u8: jax.Array, *, k: int, alphabet_size: int):
    """int32[S**k] full histogram (small keyspaces; bin == lexicographic rank).

    The host applies the min-count filter and decodes nonzero bins; the
    transfer is S**k * 4 bytes (e.g. 62 KB for protein k=3), far below any
    sort-path output.
    """
    from mercat2_tpu.ops.dense_hist import dense_kmer_index

    valid = window_validity(codes_u8, k, alphabet_size)
    idx = dense_kmer_index(codes_u8, k, alphabet_size)
    nbins = alphabet_size**k
    return jnp.zeros((nbins,), jnp.int32).at[
        jnp.where(valid, idx, nbins)
    ].add(1, mode="drop")
