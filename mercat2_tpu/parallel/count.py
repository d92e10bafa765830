"""Sharded k-mer counting over a ('data', 'bins') device mesh.

Stream sharding uses a (k-1)-symbol halo: shard d covers window start
positions [d*L, (d+1)*L) of the global stream and carries the next k-1
symbols so every window is counted exactly once and none straddles a shard
boundary invisibly. This is the device equivalent of the reference's Chunker
record-boundary splitting (/root/reference/lib/mercat2_Chunker.py:39-59) —
but exact, because the halo preserves cross-cut windows while the Chunker
relies on record boundaries.

Two reduction strategies:

- dense (small k): per-device histogram, ``psum_scatter`` over ``bins`` then
  ``psum`` over ``data`` — each device ends up owning a contiguous bin range
  of the fully-merged histogram. Replaces the reference's driver dict merge
  (/root/reference/bin/mercat2.py:121-127).
- sorted (large k): a scalable distributed sort-count. Each device locally
  sorts its shard's keys, the devices agree on D-1 key-range splitters from
  gathered samples, each device routes its sorted segments to their owner
  with ONE ``all_to_all``, and every device then re-sorts only ~N/D rows and
  runs the full RLE + min-count + compaction finalize locally. Because the
  partition is by key range, every run of equal keys lands on exactly one
  device, so per-device run lengths are globally exact and the concatenated
  per-device tables are the globally sorted, already-filtered count table.
  Work per device is O(N/D log N/D) + O(N/D) communication — the actual
  distributed merge the reference approximates with its driver-side dict
  merge (/root/reference/bin/mercat2.py:118-127).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mercat2_tpu.ops.dense_hist import dense_kmer_histogram
from mercat2_tpu.ops.kmer_pack import (
    key_words_for,
    pack_kmer_words,
    window_validity,
)

__all__ = [
    "shard_stream", "shard_stream_blocks", "shard_packed_words",
    "sharded_dense_histogram", "sharded_count_streams",
    "sharded_count_sources", "flat_mesh",
]

_ONES32 = jnp.uint32(0xFFFFFFFF)


def _bucket8(n: int, floor: int = 1024) -> int:
    """Round up to eighth-power-of-two granularity (bounded compile shapes)."""
    n = max(n, floor)
    e = (n - 1).bit_length()
    step = 1 << max(e - 3, 0)
    return -(-n // step) * step


def shard_stream(stream: np.ndarray, k: int, n_shards: int, sentinel: int) -> np.ndarray:
    """uint8[N] stream -> uint8[n_shards, L + k - 1] haloed shard matrix.

    L = ceil(N / n_shards) window starts per shard, rounded up to an
    eighth-power-of-two bucket so the compiled program-shape family stays
    small WITHOUT padding the stream itself to a bucket first (which would
    concentrate all data — and all sort work — on the leading shards). The
    trailing k-1 symbols of each row replicate the head of the next shard.
    Tail rows are sentinel padded, so their surplus windows are invalid and
    drop out downstream. Callers should pass the TRIMMED stream.
    """
    n = int(stream.shape[0])
    L = _bucket8(-(-max(n, 1) // n_shards))
    total = n_shards * L + k - 1
    padded = np.full(total, sentinel, np.uint8)
    padded[:n] = stream
    idx = np.arange(L + k - 1)[None, :] + (np.arange(n_shards) * L)[:, None]
    return padded[idx]


#: window starts per block of the block-cyclic shard layout (sort path).
#: Small enough to mix every file/key region into every device, large
#: enough that the k-1 halo per block stays negligible (<= 3% at k=128).
_BLOCK = 4096


def shard_stream_blocks(stream: np.ndarray, k: int, n_shards: int,
                        sentinel: int, block: int = _BLOCK) -> np.ndarray:
    """uint8[N] -> uint8[n_shards, nbpd * (block+k-1)] block-cyclic rows.

    Block j covers window starts [j*block, (j+1)*block) plus a k-1 halo and
    is assigned to device j % n_shards, so every device holds a
    representative sample of the whole stream. Contiguous sharding instead
    concentrates each device's keys in one file's fid range (files are laid
    out back to back), which skews the all_to_all segment sizes by up to
    n_files x. Window starts at in-slot offset >= block are duplicates of
    the next block and must be masked by the consumer.
    """
    n = int(stream.shape[0])
    nb = max(1, -(-n // block))
    nbpd = _bucket8(-(-nb // n_shards), floor=1)  # bounded shape family
    row_sym = block + k - 1
    padded = np.full(n_shards * nbpd * block + k - 1, sentinel, np.uint8)
    padded[:n] = stream
    blk = (np.arange(nbpd)[None, :] * n_shards
           + np.arange(n_shards)[:, None])  # [D, nbpd] global block ids
    idx = blk[:, :, None] * block + np.arange(row_sym)[None, None, :]
    return padded[idx].reshape(n_shards, nbpd * row_sym)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(
    jax.jit, static_argnames=("k", "alphabet_size", "mesh"), donate_argnums=(0,)
)
def _dense_hist_sharded(shards, *, k: int, alphabet_size: int, mesh: Mesh):
    data_sz = mesh.shape["data"]
    bins_sz = mesh.shape["bins"]
    nbins = alphabet_size**k
    nbins_pad = _round_up(nbins, bins_sz)

    def step(local):  # local: uint8[1, 1, row]
        hist = dense_kmer_histogram(local[0, 0], k=k, alphabet_size=alphabet_size)
        hist = jnp.pad(hist, (0, nbins_pad - nbins))
        # scatter bins intra-axis first (cheap), then sum partials over data
        shard = jax.lax.psum_scatter(hist, "bins", scatter_dimension=0, tiled=True)
        return jax.lax.psum(shard, "data")

    return shard_map(
        step,
        mesh=mesh,
        in_specs=P("data", "bins", None),
        out_specs=P("bins"),
    )(shards)


def sharded_dense_histogram(
    shards: np.ndarray, *, k: int, alphabet_size: int, mesh: Mesh
) -> np.ndarray:
    """Fully-merged dense histogram (int64 on host) from haloed shards.

    ``shards`` must have ``mesh.size`` rows (see :func:`shard_stream`);
    they are laid out row-major over the (data, bins) mesh grid.
    """
    data_sz = mesh.shape["data"]
    bins_sz = mesh.shape["bins"]
    assert shards.shape[0] == data_sz * bins_sz, (shards.shape, mesh.shape)
    arr = shards.reshape(data_sz, bins_sz, shards.shape[1])
    sharding = NamedSharding(mesh, P("data", "bins", None))
    arr = jax.device_put(jnp.asarray(arr), sharding)
    hist = _dense_hist_sharded(arr, k=k, alphabet_size=alphabet_size, mesh=mesh)
    nbins = alphabet_size**k
    return np.asarray(hist)[:nbins].astype(np.int64)


#: samples taken per device for splitter agreement. More samples -> tighter
#: load balance; D*S uint32s ride one tiny all_gather either way.
_SAMPLES = 64


def _sort_words_for(k: int, bits: int, n_files: int) -> tuple[int, int]:
    """(total sort-key words, trailing words stripped after the sort) for
    build_keyed_words' column layout."""
    from mercat2_tpu.ops.finalize import fid_layout

    payload = max(1, -(-(k * bits) // 32))
    if n_files == 1:
        _, tiebreak = key_words_for(k, bits)
        return payload + int(tiebreak), int(tiebreak)
    mode, _ = fid_layout(k, bits, n_files)
    return payload + (1 if mode == "word" else 0), 0


def _splitter_sig_bits(k: int, bits: int, n_files: int) -> int:
    """Significant LOW bits of sort-key word 0 for VALID rows.

    Splitter agreement partitions on a 32-bit fused key built from words
    (0, 1): word 0 alone can carry as few as 2 significant bits (k=17 nt:
    top word holds k*bits - 32 = 2 key bits; multi-file "word" fid mode:
    word 0 IS the file id), which would leave most devices without data and
    balloon seg_cap retries. Fusing word 1's high bits restores full 32-bit
    splitter entropy while preserving lexicographic order.
    """
    from mercat2_tpu.ops.finalize import fid_layout

    payload = max(1, -(-(k * bits) // 32))
    kb0 = k * bits - 32 * (payload - 1)
    if n_files == 1:
        return kb0
    mode, shift = fid_layout(k, bits, n_files)
    fid_bits = max(1, n_files.bit_length())
    return shift + fid_bits if mode == "embedded" else fid_bits


def _fused_splitter_key(words, sig0: int):
    """uint32 order-preserving fusion of sorted key words (0, 1).

    For valid rows word 0 < 2**sig0, so ``(w0 << (32-sig0)) | (w1 >> sig0)``
    is monotone in (w0, w1); invalid rows (all-ones in every word) map to
    all-ones and keep sorting last. Rows with equal FULL keys always share a
    fused value, so searchsorted(side="right") never splits a run.
    """
    if sig0 >= 32 or len(words) < 2:
        return words[0]
    return (words[0] << jnp.uint32(32 - sig0)) | (words[1] >> jnp.uint32(sig0))


@functools.partial(
    jax.jit,
    static_argnames=("k", "bits", "alphabet_size", "cap", "n_files",
                     "seg_cap", "block", "mesh"),
)
def _sharded_count_device(shards, file_starts, min_count, *, k: int,
                          bits: int, alphabet_size: int, cap: int,
                          n_files: int, seg_cap: int, block: int, mesh: Mesh):
    """The distributed sort-count program (see module docstring).

    shards: uint8[D, nbpd * (block + k - 1)] block-cyclic haloed rows
    (shard_stream_blocks layout). Returns per-device stacked
    (words..., counts, n_out, n_dropped): device d's table rows cover an
    exclusive key range that ascends with d, so the concatenation of the
    d-th prefixes is the global sorted table. ``n_dropped`` > 0 means a
    routing segment overflowed ``seg_cap`` (extreme key skew); the caller
    must retry with a larger factor.
    """
    from mercat2_tpu.ops.finalize import build_keyed_words, finalize_sorted

    axis = mesh.axis_names[0]
    D = mesh.shape[axis]
    row_sym = block + k - 1
    sig0 = _splitter_sig_bits(k, bits, n_files)

    def step(local, starts, minc):
        row = local[0]
        d = jax.lax.axis_index(axis)
        p = row.shape[0] - k + 1
        pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
        bi = pos // row_sym  # in-row block slot
        off = pos % row_sym  # window start within the slot
        # off >= block duplicates the next block's head: mask it out
        valid = window_validity(row, k, alphabet_size) & (off < block)
        payload = pack_kmer_words(row.astype(jnp.uint32), k, bits)
        if n_files > 1:
            pos_g = (bi * D + d) * block + off  # global window start
            fid = (
                jnp.searchsorted(starts, pos_g, side="right") - 1
            ).astype(jnp.uint32)
        else:
            fid = None
        keyed, strip = build_keyed_words(payload, valid, fid, k, bits, n_files)
        n_valid = jnp.sum(valid, dtype=jnp.int32)
        return _route_finalize(
            keyed, strip, n_valid, minc,
            sig0=sig0, axis=axis, D=D, seg_cap=seg_cap, cap=cap,
        )

    total_w, strip_w = _sort_words_for(k, bits, n_files)
    word_specs = tuple([P(axis, None)] * (total_w - strip_w))
    return shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P()),
        out_specs=word_specs + (P(axis, None), P(axis), P(axis)),
    )(shards, file_starts, min_count)


def _route_finalize(keyed, strip: int, n_valid, minc, *, sig0: int, axis: str,
                    D: int, seg_cap: int, cap: int):
    """Shared tail of the distributed sort-count device programs:

    local sort -> weighted-sample splitter agreement -> key-range routing
    with ONE all_to_all -> local exact finalize on ~N/D rows. ``keyed`` are
    the masked sort-key columns (invalid rows all-ones, see
    ops.finalize.build_keyed_words).
    """
    from mercat2_tpu.ops.finalize import finalize_sorted

    W = len(keyed)
    words = jax.lax.sort(tuple(keyed), num_keys=W)
    p = words[0].shape[0]
    fused = _fused_splitter_key(words, sig0)

    # --- splitter agreement: S regular samples of the valid prefix, each
    # weighted by its device's valid count so devices with little (or no)
    # data don't drag the global quantile estimate toward their
    # invalid-marker samples. Splitter j = the sample where the weight
    # prefix-sum crosses (j+1)/D of the total weight.
    ranks = ((jax.lax.broadcasted_iota(jnp.int32, (_SAMPLES,), 0) + 1)
             * n_valid) // (_SAMPLES + 1)
    smp = fused[jnp.clip(ranks, 0, p - 1)]
    wgt = jnp.full((_SAMPLES,), 1.0, jnp.float32) * n_valid.astype(jnp.float32)
    allsmp = jax.lax.all_gather(smp, axis, tiled=True)
    allwgt = jax.lax.all_gather(wgt, axis, tiled=True)
    ssmp, swgt = jax.lax.sort((allsmp, allwgt), num_keys=1)
    cumw = jnp.cumsum(swgt)
    targets = (
        (jax.lax.broadcasted_iota(jnp.float32, (D - 1,), 0) + 1.0)
        * (cumw[-1] / D)
    )
    spl_idx = jnp.clip(
        jnp.searchsorted(cumw, targets, side="left"), 0, D * _SAMPLES - 1
    )
    splitters = ssmp[spl_idx]  # uint32[D-1], ascending

    # --- local segments owned by each destination device ------------------
    # side='right': keys equal to a splitter all go to the lower device, so
    # a run of equal (fused, hence full) keys is never split across devices.
    bounds = jnp.minimum(
        jnp.searchsorted(fused, splitters, side="right").astype(jnp.int32),
        n_valid,
    )
    seg_start = jnp.concatenate([jnp.zeros((1,), jnp.int32), bounds])
    seg_end = jnp.concatenate([bounds, n_valid[None]])
    seg_len = seg_end - seg_start
    sent = jnp.minimum(seg_len, seg_cap)
    n_dropped = jax.lax.psum(jnp.sum(seg_len - sent), axis)

    # --- route: one all_to_all of [D, seg_cap] per key word ---------------
    idx = seg_start[:, None] + jax.lax.broadcasted_iota(
        jnp.int32, (D, seg_cap), 1
    )
    mask = idx < jnp.minimum(seg_end, seg_start + seg_cap)[:, None]
    idxc = jnp.minimum(idx, p - 1)
    recv = [
        jax.lax.all_to_all(
            jnp.where(mask, w[idxc], _ONES32), axis,
            split_axis=0, concat_axis=0,
        ).reshape(D * seg_cap)
        for w in words
    ]
    n_recv = jnp.sum(
        jax.lax.all_to_all(sent, axis, split_axis=0, concat_axis=0),
        dtype=jnp.int32,
    )

    # --- local exact finalize on ~N/D rows ---------------------------------
    merged = jax.lax.sort(tuple(recv), num_keys=W)
    out_words, out_counts, n_out = finalize_sorted(
        merged[: W - strip], n_recv, minc, cap
    )
    return (
        tuple(w[None] for w in out_words)
        + (out_counts[None], n_out[None], n_dropped[None])
    )


def shard_packed_words(words: np.ndarray, k: int, per: int, n_shards: int,
                       block: int) -> tuple[np.ndarray, int, int]:
    """Block-cyclic shard matrix over bit-packed uint32 words.

    The packed-transport equivalent of :func:`shard_stream_blocks`: block j
    covers window starts [j*block, (j+1)*block) plus a halo rounded up to a
    word boundary, so every slot is a whole-word slice of the packed stream
    and h2d ships ``bits`` per symbol instead of 8. ``block`` must be a
    multiple of ``per`` (any power of two >= 32 is).

    Returns (wshards uint32[n_shards, nbpd*slot_w], nbpd, slot_sym).
    """
    assert block % per == 0
    halo_sym = -(-(k - 1) // per) * per
    slot_sym = block + halo_sym
    slot_w = slot_sym // per
    block_w = block // per
    nw = int(words.shape[0])
    n_sym = nw * per
    nb = max(1, -(-n_sym // block))
    nbpd = _bucket8(-(-nb // n_shards), floor=1)
    need = (n_shards * nbpd - 1) * block_w + slot_w
    padded = np.zeros(need, np.uint32)
    padded[:nw] = words
    blk = (np.arange(nbpd)[None, :] * n_shards
           + np.arange(n_shards)[:, None])  # [D, nbpd]
    idx = blk[:, :, None] * block_w + np.arange(slot_w)[None, None, :]
    return padded[idx].reshape(n_shards, nbpd * slot_w), nbpd, slot_sym


@functools.partial(
    jax.jit,
    static_argnames=("k", "bits", "alphabet_size", "cap", "n_files",
                     "seg_cap", "block", "slot_sym", "mesh"),
)
def _sharded_count_packed_device(wshards, gap_begin, gap_end, file_starts,
                                 n_total, min_count, *, k: int, bits: int,
                                 alphabet_size: int, cap: int, n_files: int,
                                 seg_cap: int, block: int, slot_sym: int,
                                 mesh: Mesh):
    """Distributed sort-count from bit-packed block-cyclic word shards.

    Identical partition/routing/finalize semantics to
    :func:`_sharded_count_device`; the differences are transport-side:
    symbols arrive packed (4x fewer h2d bytes for DNA), record/file gaps
    are out-of-band SORTED half-open symbol ranges (no sentinel codes), and
    ``n_total`` (traced) bounds the real content.
    """
    from mercat2_tpu.ops.finalize import build_keyed_words, unpack_codes

    axis = mesh.axis_names[0]
    D = mesh.shape[axis]
    sig0 = _splitter_sig_bits(k, bits, n_files)
    G = int(gap_begin.shape[0])

    def step(local, gb, ge, starts, ntot, minc):
        row_words = local[0]
        d = jax.lax.axis_index(axis)
        n_sym = row_words.shape[0] * (32 // bits)
        codes = unpack_codes(row_words, bits, n_sym)
        p = n_sym - k + 1
        pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
        bi = pos // slot_sym
        off = pos % slot_sym
        g = (bi * D + d) * block + off  # global window start
        in_range = (off < block) & (g <= ntot - k)
        # window [g, g+k) intersects gap range [b, e) iff b-k+1 <= g < e;
        # ranges are disjoint and sorted, so test only the first e > g.
        j = jnp.searchsorted(ge, g, side="right")
        jc = jnp.minimum(j, G - 1)
        hit = (j < G) & (gb[jc] - jnp.int32(k - 1) <= g)
        valid = in_range & jnp.logical_not(hit)
        payload = pack_kmer_words(codes, k, bits)
        if n_files > 1:
            fid = (
                jnp.searchsorted(starts, g, side="right") - 1
            ).astype(jnp.uint32)
        else:
            fid = None
        keyed, strip = build_keyed_words(payload, valid, fid, k, bits, n_files)
        n_valid = jnp.sum(valid, dtype=jnp.int32)
        return _route_finalize(
            keyed, strip, n_valid, minc,
            sig0=sig0, axis=axis, D=D, seg_cap=seg_cap, cap=cap,
        )

    total_w, strip_w = _sort_words_for(k, bits, n_files)
    word_specs = tuple([P(axis, None)] * (total_w - strip_w))
    return shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P(), P(), P(), P()),
        out_specs=word_specs + (P(axis, None), P(axis), P(axis)),
    )(wshards, gap_begin, gap_end, file_starts, n_total, min_count)


#: per-device budget for the distributed-sort routing buffers on a backend
#: that reports no memory limit (the CPU backend the tests run on). The
#: route ships [D, seg_cap] per key word (send gather + all_to_all receive
#: + merged sort copy ~= 3 live copies), i.e. ~12 * W * over * L bytes per
#: device for L owned window starts; launches are batched so the estimate
#: stays under the budget.
_ROUTE_HBM_BUDGET = 128 << 20

#: share of a device's memory limit (``memory_stats()["bytes_limit"]``)
#: granted to the routing buffers; the rest holds the shards, the local
#: sort's scratch and the finalize. 1/128 is the ratio the fixed budget
#: had to the 16 GB device it was sized for. Not measured on the H100.
_ROUTE_MEMORY_SHARE = 1 / 128


def route_hbm_budget(device) -> int:
    """Per-device routing budget in bytes: ``_ROUTE_MEMORY_SHARE`` of the
    device's memory limit. The CPU backend reports no limit and keeps the
    fixed ``_ROUTE_HBM_BUDGET``; an accelerator without one is an error,
    not a default."""
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return int(limit * _ROUTE_MEMORY_SHARE)
    if device.platform == "cpu":
        return _ROUTE_HBM_BUDGET
    raise RuntimeError(
        f"{device.platform} device {device.device_kind} reports no memory "
        "limit; cannot size the routing buffers"
    )


def _route_batches(counter, sources: list, D: int, overprovision: float,
                   hbm_budget: int) -> list[list[int]]:
    """Greedy batches of source indices whose routing footprint fits the
    per-device memory budget (see route_hbm_budget). A single oversized file
    still gets its own launch (per-file min-count semantics need every
    window of a file in one launch); its overshoot is reported via stats.
    """
    from mercat2_tpu.engine.counter import _REC_GAP

    W, _ = _sort_words_for(counter.k, counter.codec.bits, len(sources))
    bytes_per_sym = 12.0 * W * max(1.0, overprovision) / D  # per device
    max_content = max(1, int(hbm_budget / bytes_per_sym))
    batches: list[list[int]] = []
    cur: list[int] = []
    cur_sym = 0
    for i, s in enumerate(sources):
        length = s.packed_len(_REC_GAP) + _REC_GAP
        if cur and cur_sym + length > max_content:
            batches.append(cur)
            cur, cur_sym = [], 0
        cur.append(i)
        cur_sym += length
    if cur:
        batches.append(cur)
    return batches


def sharded_count_sources(counter, sources: list, min_count: int,
                          mesh: Mesh | None = None, *,
                          overprovision: float = 2.0,
                          hbm_budget: int | None = None,
                          stats: dict | None = None) -> list:
    """Mesh-parallel count of several files from packed-transport sources.

    Same output contract as :func:`sharded_count_streams` (one exact,
    per-file min-count-filtered, lexicographically sorted KmerTable per
    source), but the h2d transport ships the same bit-packed words as the
    single-chip packed path (engine.counter.build_packed_group) — 4x fewer
    bytes for DNA on real multi-chip hardware. Requires a packable codec
    (``bits <= 6``; whole words carry ``per = 32 // bits`` symbols, any
    spare high bits stay zero — e.g. the 5-bit protein codec packs 6
    symbols per word with 2 spare bits).

    Launches are batched so the routing buffers stay under ``hbm_budget``
    bytes per device (default :func:`route_hbm_budget` of the mesh's first
    device; files stay whole within a batch, preserving the per-file
    filter semantics; batches reuse the same compiled program shapes when
    their bucketed sizes agree).
    """
    n_files = len(sources)
    if n_files == 0:
        return []
    if mesh is None:
        mesh = flat_mesh()
    D = int(mesh.shape[mesh.axis_names[0]])
    if hbm_budget is None:
        hbm_budget = route_hbm_budget(mesh.devices.flat[0])
    batches = _route_batches(counter, sources, D, overprovision, hbm_budget)
    if len(batches) > 1:
        result: list = [None] * n_files
        for b in batches:
            tables = _sharded_count_sources_one(
                counter, [sources[i] for i in b], min_count, mesh,
                overprovision=overprovision, stats=stats,
            )
            for row, i in enumerate(b):
                result[i] = tables[row]
        if stats is not None:
            stats.update(route_batches=len(batches))
        return result
    return _sharded_count_sources_one(
        counter, sources, min_count, mesh,
        overprovision=overprovision, stats=stats,
    )


def _sharded_count_sources_one(counter, sources: list, min_count: int,
                               mesh: Mesh | None = None, *,
                               overprovision: float = 2.0,
                               stats: dict | None = None) -> list:
    """One mesh launch group of :func:`sharded_count_sources`."""
    from mercat2_tpu.engine.counter import (
        KmerTable, _DEFAULT_CAP, _split_fid_tables,
    )
    from mercat2_tpu.ops.finalize import fid_layout

    if mesh is None:
        mesh = flat_mesh()
    axis = mesh.axis_names[0]
    D = int(mesh.shape[axis])
    k, codec = counter.k, counter.codec
    per = 32 // codec.bits
    n_files = len(sources)
    if n_files == 0:
        return []
    group = counter.build_packed_group(sources)
    if group is None:
        return [KmerTable.empty(k)] * n_files

    content = group.content_end
    # block must be a whole number of packed words; per is not always a
    # power of two (5-bit protein codes pack 6 per word), so express the
    # block as per * factor and shrink the factor for small streams.
    factor = _BLOCK // 16
    while factor > 64 and content < 4 * D * per * factor:
        factor //= 2
    block = per * factor
    wshards, nbpd, slot_sym = shard_packed_words(
        group.words, k, per, D, block
    )
    L = nbpd * block  # owned window starts per device
    order = np.argsort(group.gap_begin, kind="stable")
    gb = np.ascontiguousarray(group.gap_begin[order])
    ge = np.ascontiguousarray(group.gap_end[order])

    if n_files == 1:
        mode, shift = "none", 0
    else:
        mode, shift = fid_layout(k, codec.bits, n_files)

    sharding = NamedSharding(mesh, P(axis, None))
    dev_in = (
        jax.device_put(jnp.asarray(wshards), sharding),
        jnp.asarray(gb), jnp.asarray(ge),
        jnp.asarray(group.file_starts),
        jnp.int32(content),
    )
    cap = min(L, max(1 << 14, counter._keyspace() // max(1, D)))
    if min_count > 1:
        cap = min(cap, _DEFAULT_CAP)
    over = overprovision
    skew_retries = cap_retries = 0
    while True:
        seg_cap = max(128, int(over * L / D + 127) // 128 * 128)
        seg_cap = min(seg_cap, L)
        out = _sharded_count_packed_device(
            *dev_in, jnp.int32(min_count),
            k=k, bits=codec.bits, alphabet_size=codec.size, cap=cap,
            n_files=n_files, seg_cap=seg_cap, block=block,
            slot_sym=slot_sym, mesh=mesh,
        )
        n_out = np.asarray(out[-2])
        n_dropped = int(np.asarray(out[-1])[0])
        if n_dropped > 0:
            if seg_cap >= L:
                raise RuntimeError("sharded count: segment overflow at L")
            over *= 2.0
            skew_retries += 1
            continue
        if int(n_out.max()) > cap:
            cap = int(1 << int(n_out.max() - 1).bit_length())
            cap_retries += 1
            continue
        break
    if stats is not None:
        W, _ = _sort_words_for(k, codec.bits, n_files)
        stats.update(skew_retries=skew_retries, cap_retries=cap_retries,
                     seg_cap=seg_cap, n_devices=D, block=block,
                     route_bytes_per_device=12 * W * D * seg_cap)

    word_cols = [np.asarray(w) for w in out[:-3]]
    counts = np.asarray(out[-3])
    cols_full = [
        np.concatenate([w[d, : n_out[d]] for d in range(D)])
        for w in word_cols
    ]
    counts_full = np.concatenate([counts[d, : n_out[d]] for d in range(D)])
    total = int(n_out.sum())
    return _split_fid_tables(
        counter, cols_full + [counts_full], total, mode, shift, n_files
    )


def flat_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D ('shards',) mesh over the first n devices (default: all LOCAL).

    Under multi-host execution every process builds its own mesh from its
    addressable devices only — hosts own disjoint input files (see
    mercat2_tpu.parallel.dist.host_shard), so counting is a process-local
    computation and a global mesh would make ``jax.device_put`` of
    host-local data crash on non-addressable devices.
    """
    if devices is None:
        devices = (
            jax.local_devices() if jax.process_count() > 1 else jax.devices()
        )
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(np.asarray(devices[:n_devices]), axis_names=("shards",))


def sharded_count_streams(counter, streams: list, min_count: int,
                          mesh: Mesh | None = None, *,
                          overprovision: float = 2.0,
                          stats: dict | None = None) -> list:
    """Count several files' code streams across a device mesh; one exact,
    min-count-filtered, lexicographically sorted KmerTable per file.

    This is the mesh-parallel equivalent of
    ``KmerCounter.dispatch_streams(...) + fetch_tables`` — identical output
    (per-file filter semantics, /root/reference/lib/mercat2_kmers.py:73-76),
    computed with O(N/D) per-device work and one all_to_all. Retries with
    larger routing capacity on pathological key skew, and with a larger
    output cap on table overflow.

    ``counter`` is a KmerCounter (k + codec); ``streams`` are raw uint8 code
    streams (trailing sentinel padding is fine).
    """
    from mercat2_tpu.engine.counter import (
        KmerTable, _split_fid_tables, _trim_sentinels,
    )
    from mercat2_tpu.ops.finalize import fid_layout

    if mesh is None:
        mesh = flat_mesh()
    axis = mesh.axis_names[0]
    D = int(mesh.shape[axis])
    k, codec = counter.k, counter.codec
    n_files = len(streams)
    if n_files == 0:
        return []

    trimmed = [_trim_sentinels(s, codec.sentinel) for s in streams]
    live = [i for i, t in enumerate(trimmed) if t.shape[0] >= k]
    if not live:
        return [KmerTable.empty(k)] * n_files
    live_streams = [trimmed[i] for i in live]
    combined, starts = counter._combine_streams(live_streams)
    # block-cyclic sharding of the TRUE content (not the compile-shape
    # bucket padding): every device gets a representative mix of the whole
    # stream, so the all_to_all segment sizes stay ~L/D even though files
    # are laid out contiguously. Row shapes come from a bucketed
    # blocks-per-device count, keeping the compiled family small.
    true_total = int(starts[-1]) + live_streams[-1].shape[0]
    # adaptive power-of-two block: at least ~4 blocks per device so small
    # streams still mix across the mesh (a device holding a single
    # contiguous block sees only one file's key range).
    block = _BLOCK
    while block > 256 and true_total < 4 * D * block:
        block //= 2
    shards = shard_stream_blocks(
        combined[:true_total], k, D, codec.sentinel, block
    )
    nbpd = shards.shape[1] // (block + k - 1)
    L = nbpd * block  # owned window starts per device

    if len(live) == 1:
        mode, shift = "none", 0
    else:
        mode, shift = fid_layout(k, codec.bits, len(live))

    sharding = NamedSharding(mesh, P(axis, None))
    dshards = jax.device_put(jnp.asarray(shards), sharding)
    dstarts = jnp.asarray(starts.astype(np.int32))
    cap = min(L, max(1 << 14, counter._keyspace() // max(1, D)))
    if min_count > 1:
        from mercat2_tpu.engine.counter import _DEFAULT_CAP

        cap = min(cap, _DEFAULT_CAP)
    over = overprovision
    skew_retries = cap_retries = 0
    while True:
        seg_cap = max(128, int(over * L / D + 127) // 128 * 128)
        seg_cap = min(seg_cap, L)
        out = _sharded_count_device(
            dshards, dstarts, jnp.int32(min_count),
            k=k, bits=codec.bits, alphabet_size=codec.size, cap=cap,
            n_files=len(live), seg_cap=seg_cap, block=block, mesh=mesh,
        )
        n_out = np.asarray(out[-2])
        n_dropped = int(np.asarray(out[-1])[0])
        if n_dropped > 0:
            if seg_cap >= L:  # cannot grow further; should be impossible
                raise RuntimeError("sharded count: segment overflow at L")
            over *= 2.0
            skew_retries += 1
            continue
        if int(n_out.max()) > cap:
            cap = int(1 << int(n_out.max() - 1).bit_length())
            cap_retries += 1
            continue
        break
    if stats is not None:
        stats.update(skew_retries=skew_retries, cap_retries=cap_retries,
                     seg_cap=seg_cap, n_devices=D)

    word_cols = [np.asarray(w) for w in out[:-3]]  # each [D, cap]
    counts = np.asarray(out[-3])  # [D, cap]
    cols_full = [
        np.concatenate([w[d, : n_out[d]] for d in range(D)])
        for w in word_cols
    ]
    counts_full = np.concatenate([counts[d, : n_out[d]] for d in range(D)])
    total = int(n_out.sum())
    tables = _split_fid_tables(
        counter, cols_full + [counts_full], total, mode, shift, len(live)
    )
    result = [KmerTable.empty(k)] * n_files
    for row, i in enumerate(live):
        result[i] = tables[row]
    return result
