"""Host-side orchestration of the device k-mer count engine.

Pipeline per input file (the reference's unit of work too — its per-chunk
min-count filter happens per *file*, /root/reference/lib/mercat2_kmers.py:73-76):

    parse FASTA -> sequence bytes + record ids      (mercat2_tpu.io.fasta)
    -> data-driven codec                             (engine.codec)
    -> separator-delimited, bucket-padded code stream
    -> device: pack + sort                           (ops.kmer_pack)
    -> host: run-length encode, min-count filter, decode to byte strings

The result is a :class:`KmerTable`: parallel arrays of k-mer byte strings
((M, k) uint8 matrix) and counts, already in lexicographic order — exactly
the order the reference writes TSVs in (/root/reference/bin/mercat2.py:132).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from mercat2_tpu.engine.codec import Codec, codec_for_bytes
from mercat2_tpu.ops.kmer_pack import key_words_for

__all__ = [
    "KmerTable", "KmerCounter", "PendingCount", "PackedGroup", "count_file",
    "count_files_merged", "fetch_tables",
]

#: symbols between consecutive records in the packed transport. One is
#: enough: validity comes from gap *ranges* widened by k-1 on device
#: (ops.finalize.packed_window_validity), not from sentinel codes, so any
#: non-empty gap kills every window that would span the boundary.
_REC_GAP = 1

#: Streams are padded up to one of these sizes to bound recompilations.
_MIN_BUCKET = 1 << 16

#: The device pack loop unrolls O(k) elementwise passes and the sort
#: carries ceil(k*bits/32) operands; beyond this bound we take an exact
#: host (numpy) path instead of compiling a pathological kernel. 256 keeps
#: every realistic k on the accelerator (a 256-mer DNA key is 16 sort
#: words); compile time grows with the operand count, so the cap is a
#: compile-cost guard, not a correctness limit.
_MAX_DEVICE_K = 256

#: Single chip always uses the sorted path: it measured 1.6-2.4x FASTER
#: than scatter-add dense histograms even for tiny keyspaces, and its output
#: cap is bounded by min(windows, S**k). The dense-histogram ops remain for
#: the multi-chip psum merge (mercat2_tpu.parallel).

#: Default output capacity of the compacted device table when a min-count
#: filter is active (rows; 12-16 bytes each over the wire). Genuine
#: overflows are caught by n_out and retried with a bucketed larger cap
#: (2^14 keeps the 5-genome k=5 protein tables, up to ~12K rows/file,
#: retry-free). Not measured on the H100.
_DEFAULT_CAP = 1 << 14


def _bucket_size(n: int) -> int:
    """Round up to eighth-power-of-two granularity (<= 12.5% padding).

    Device sort cost scales ~n log^2 n, so padding waste is pure loss; the
    persistent compilation cache makes the handful of extra program shapes
    (8 per octave) free after first use.
    """
    if n <= _MIN_BUCKET:
        return _MIN_BUCKET
    e = (n - 1).bit_length()  # 2**e >= n
    step = 1 << (e - 3)
    return -(-n // step) * step


def _trim_sentinels(stream: np.ndarray, sentinel: int) -> np.ndarray:
    """Strip trailing sentinel padding (raw streams never end in one).

    Scans backwards in blocks: cost is O(padding), not O(stream) — a full
    flatnonzero over a genome-sized stream costs ~50 ms of pure host time.
    """
    end = stream.shape[0]
    block = 1 << 16
    while end > 0:
        s = max(0, end - block)
        nz = np.flatnonzero(stream[s:end] != sentinel)
        if nz.size:
            return stream[: s + int(nz[-1]) + 1]
        end = s
    return stream[:0]


@dataclasses.dataclass
class KmerTable:
    """Sorted (k-mer, count) table.

    kmers: uint8[M, k] — ASCII bytes of each k-mer, lexicographically sorted.
    counts: int64[M].
    """

    kmers: np.ndarray
    counts: np.ndarray

    @property
    def k(self) -> int:
        return int(self.kmers.shape[1]) if self.kmers.ndim == 2 else 0

    def __len__(self) -> int:
        return int(self.counts.shape[0])

    def kmer_strings(self) -> list[str]:
        k = self.k
        flat = self.kmers.tobytes()
        return [flat[i * k : (i + 1) * k].decode("latin-1") for i in range(len(self))]

    def to_dict(self) -> dict[str, int]:
        return dict(zip(self.kmer_strings(), (int(c) for c in self.counts)))

    @staticmethod
    def empty(k: int) -> "KmerTable":
        return KmerTable(np.zeros((0, k), np.uint8), np.zeros(0, np.int64))


def _decode_payload(words: np.ndarray, k: int, bits: int, codec: Codec) -> np.ndarray:
    """uint32[M, payload] big-endian packed keys -> uint8[M, k] ASCII bytes."""
    m, payload = words.shape
    mask = np.uint32((1 << bits) - 1)
    out = np.empty((m, k), dtype=np.uint8)
    for j in range(k):
        bitpos = bits * (k - 1 - j)  # from LSB of the whole payload
        col = payload - 1 - bitpos // 32
        off = bitpos % 32
        sym = words[:, col] >> np.uint32(off)
        spill = off + bits - 32
        if spill > 0:
            sym = sym | (
                (words[:, col - 1] & np.uint32((1 << spill) - 1))
                << np.uint32(32 - off)
            )
        out[:, j] = (sym & mask).astype(np.uint8)
    return codec.symbols[out]


def _rle(sorted_cols: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode parallel sorted columns -> (start_indices, counts)."""
    n = sorted_cols[0].shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.zeros(n, dtype=bool)
    change[0] = True
    for col in sorted_cols:
        np.logical_or(change[1:], col[1:] != col[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    counts = np.diff(np.append(starts, n))
    return starts.astype(np.int64), counts.astype(np.int64)


def _drop_short_records(seq: np.ndarray, rec: np.ndarray, k: int):
    """Remove records shorter than k (they yield no windows). Keeps the
    separator overhead of the packed stream proportional to useful data."""
    if seq.shape[0] == 0 or k <= 1:
        return seq, rec
    # rec is non-decreasing; record boundaries are change points
    boundary = np.empty(rec.shape[0], dtype=bool)
    boundary[0] = True
    np.not_equal(rec[1:], rec[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    lens = np.diff(np.append(starts, rec.shape[0]))
    if lens.min() >= k:
        return seq, rec
    keep_rec = lens >= k
    keep = np.repeat(keep_rec, lens)
    return seq[keep], rec[keep]


def _count_host(seq: np.ndarray, rec: np.ndarray, k: int, min_count: int) -> KmerTable:
    """Exact host fallback for very large k (vectorized numpy)."""
    from numpy.lib.stride_tricks import sliding_window_view

    p = seq.shape[0] - k + 1
    windows = sliding_window_view(seq, k)
    valid = rec[: p] == rec[k - 1 :]
    rows = np.ascontiguousarray(windows[valid])
    if rows.shape[0] == 0:
        return KmerTable.empty(k)
    void = rows.view([("", np.uint8)] * k).ravel()
    uniq, counts = np.unique(void, return_counts=True)
    if min_count > 1:
        keepm = counts >= min_count
        uniq, counts = uniq[keepm], counts[keepm]
    kmers = uniq.view(np.uint8).reshape(-1, k)
    return KmerTable(kmers, counts.astype(np.int64))


@functools.partial(jax.jit, static_argnames=("m",))
def _take_prefix(arrs, *, m: int):
    """Slice each array to its first m rows on device (cheap d2h transfers)."""
    return tuple(a[:m] for a in arrs)


class PendingCount:
    """Handle to an in-flight device count. ``table()`` blocks and fetches."""

    def table(self) -> KmerTable:  # pragma: no cover - interface
        raise NotImplementedError

    def prefetch(self) -> None:
        """Start the d2h copy of the first sync point without blocking.

        Calling this on every pending count before the first ``table()``
        overlaps the per-result host roundtrips."""


def _async_to_host(arr) -> None:
    try:
        arr.copy_to_host_async()
    except AttributeError:  # pragma: no cover - non-standard backends
        pass


def _sorted_table(counter: "KmerCounter", cols: list[np.ndarray],
                  counts: np.ndarray, n_out: int) -> KmerTable:
    """Host decode of fetched (already compacted) sorted key columns."""
    if n_out == 0:
        return KmerTable.empty(counter.k)
    packed = np.stack([col[:n_out] for col in cols], axis=1)
    kmers = _decode_payload(packed, counter.k, counter.codec.bits, counter.codec)
    return KmerTable(kmers, counts[:n_out].astype(np.int64))


class _PendingSorted(PendingCount):
    def __init__(self, counter, dstream, min_count, cap, words, counts, n_out):
        self._c = counter
        self._dstream = dstream
        self._min_count = min_count
        self._cap = cap
        self._out = (words, counts, n_out)
        self._n_out: int | None = None

    def prefetch(self) -> None:
        _async_to_host(self._out[2])

    def _resolve_n(self) -> int:
        """Sync on n_out, retrying with a bigger cap on overflow (rare)."""
        if self._n_out is not None:
            return self._n_out
        from mercat2_tpu.ops.finalize import count_kmers_device

        c = self._c
        words, counts, n_out = self._out
        n_out = int(n_out)  # first sync point
        while n_out > self._cap:
            self._cap = _bucket_size(n_out)
            words, counts, n_out = count_kmers_device(
                self._dstream,
                jnp.int32(self._min_count),
                k=c.k,
                bits=c.codec.bits,
                alphabet_size=c.codec.size,
                cap=self._cap,
            )
            n_out = int(n_out)
        self._out = (words, counts, n_out)
        self._dstream = None
        self._n_out = n_out
        return n_out

    def _device_columns(self):
        """(words..., counts) device arrays after _resolve_n."""
        words, counts, _ = self._out
        return tuple(words) + (counts,)

    def _from_fetched(self, cols) -> KmerTable:
        return _sorted_table(self._c, list(cols[:-1]), cols[-1], self._n_out)

    def table(self) -> KmerTable:
        n_out = self._resolve_n()
        if n_out == 0:
            return KmerTable.empty(self._c.k)
        # transfer only the surviving prefix, padded to a power of two so a
        # handful of compiled slicers cover every n_out
        m = min(self._cap, max(512, 1 << (n_out - 1).bit_length()))
        small = jax.device_get(_take_prefix(self._device_columns(), m=m))
        return self._from_fetched(small)


def fetch_tables(pendings: list) -> list[KmerTable]:
    """Fetch every pending count with the d2h work batched.

    Per-pending ``table()`` dispatches one prefix-slice program and one
    transfer each. This groups all plain sorted pendings into ONE slice launch + ONE batched
    device_get, and all segment-group pendings (_PendingSegments behind
    _MultiView) into ONE device_get of every group's n_outs + speculative
    prefixes; other pending kinds fall back to their own ``table()``.
    """
    for p in pendings:
        p.prefetch()

    seg_groups: list = []
    seen: set[int] = set()
    for p in pendings:
        m = getattr(p, "_multi", p)
        if (isinstance(m, (_PendingSegments, _PendingPacked,
                           _PendingDenseSegments))
                and m._tables is None and id(m) not in seen):
            seen.add(id(m))
            seg_groups.append(m)
    if len(seg_groups) > 1:
        arrs: list = []
        spans: list[tuple[int, int]] = []
        for m in seg_groups:
            a = m._fetch_arrays()
            spans.append((len(arrs), len(arrs) + len(a)))
            arrs.extend(a)
        fetched = jax.device_get(tuple(arrs))
        for m, (lo, hi) in zip(seg_groups, spans):
            m._fetch_all(fetched[lo:hi])

    plain = [
        p for p in pendings
        if isinstance(p, _PendingSorted) and p._resolve_n() > 0
    ]
    if len(plain) > 1:
        m = max(512, 1 << (max(p._n_out for p in plain) - 1).bit_length())
        arrs = []
        spans = []
        for p in plain:
            cols = p._device_columns()
            spans.append((len(arrs), len(arrs) + len(cols)))
            arrs.extend(cols)
        small = jax.device_get(_take_prefix(tuple(arrs), m=m))
        fetched = {
            id(p): p._from_fetched(small[lo:hi])
            for p, (lo, hi) in zip(plain, spans)
        }
        return [
            fetched[id(p)] if id(p) in fetched else p.table()
            for p in pendings
        ]
    return [p.table() for p in pendings]


def _split_fid_tables(counter, small, n_out: int, mode: str, shift: int,
                      n_files: int) -> list[KmerTable]:
    """Fetched (words..., counts) columns -> per-file sorted tables.

    Rows are sorted by (fid, key); the fid lives in the top bits of word 0
    ("embedded"), in a dedicated leading word ("word"), or nowhere ("none",
    single file)."""
    if mode == "embedded":
        fids = (small[0][:n_out] >> np.uint32(shift)).astype(np.int64)
        cols = [np.ascontiguousarray(w[:n_out]) for w in small[:-1]]
        cols[0] = cols[0] & np.uint32((1 << shift) - 1)
    elif mode == "word":
        fids = small[0][:n_out].astype(np.int64)
        cols = [np.ascontiguousarray(w[:n_out]) for w in small[1:-1]]
    else:  # "none": single file, no fid anywhere
        fids = np.zeros(n_out, np.int64)
        cols = [np.ascontiguousarray(w[:n_out]) for w in small[:-1]]
    cnts = small[-1][:n_out]
    bounds = np.searchsorted(fids, np.arange(n_files + 1))
    return [
        _sorted_table(
            counter, [col[bounds[f] : bounds[f + 1]] for col in cols],
            cnts[bounds[f] : bounds[f + 1]],
            int(bounds[f + 1] - bounds[f]),
        )
        for f in range(n_files)
    ]


class _EmptyPending(PendingCount):
    def __init__(self, k: int):
        self._k = k

    def table(self) -> KmerTable:
        return KmerTable.empty(self._k)


class _PendingPacked(PendingCount):
    """Result of one packed-transport launch (ops.finalize
    count_kmers_packed); splits rows per file at fetch time.

    A speculative prefix slice (``KmerCounter._SPEC_ROWS_PACKED`` rows) is
    dispatched at creation so ``fetch_tables`` can resolve a whole run of
    launches with ONE batched device_get instead of one n_out + prefix
    roundtrip per launch.
    """

    def __init__(self, counter, dev_args, min_count, cap, mode, shift,
                 n_files, n_sym, words, counts, n_out):
        self._c = counter
        self._dev = dev_args  # (dwords, dgb, dge, dstarts) for retries
        self._min_count = min_count
        self._cap = cap
        self._mode = mode
        self._shift = shift
        self._n_files = n_files
        self._n_sym = n_sym
        self._out = (words, counts, n_out)
        self._spec = _take_prefix(
            tuple(words) + (counts,), m=KmerCounter._SPEC_ROWS_PACKED
        )
        self._tables: list[KmerTable] | None = None

    def prefetch(self) -> None:
        _async_to_host(self._out[2])
        for a in self._spec:
            _async_to_host(a)

    def _fetch_arrays(self) -> tuple:
        """Device arrays one host roundtrip resolves (see fetch_tables)."""
        return (self._out[2],) + tuple(self._spec)

    def _fetch_all(self, fetched=None) -> None:
        from mercat2_tpu.ops.finalize import count_kmers_packed

        c = self._c
        if fetched is None:
            fetched = jax.device_get(self._fetch_arrays())
        n_out = int(fetched[0])
        spec = fetched[1:]
        words, counts, _ = self._out
        retried = False
        while n_out > self._cap:  # overflow: retry with room (rare)
            retried = True
            self._cap = _bucket_size(n_out)
            dwords, dgb, dge, dstarts = self._dev
            words, counts, n_out = count_kmers_packed(
                dwords, dgb, dge, dstarts, jnp.int32(self._min_count),
                k=c.k, bits=c.codec.bits, alphabet_size=c.codec.size,
                cap=self._cap, n_files=self._n_files, n_sym=self._n_sym,
            )
            n_out = int(n_out)
        self._out = self._dev = None
        if n_out == 0:
            self._tables = [KmerTable.empty(c.k)] * self._n_files
            return
        spec_have = min(self._cap, KmerCounter._SPEC_ROWS_PACKED)
        if n_out <= spec_have and not retried:
            small = [a[:n_out] for a in spec]
        else:  # speculative miss: fetch the true-size prefix
            m = min(self._cap, max(512, 1 << (n_out - 1).bit_length()))
            small = jax.device_get(
                _take_prefix(tuple(words) + (counts,), m=m)
            )
        self._tables = _split_fid_tables(
            c, small, n_out, self._mode, self._shift, self._n_files
        )

    def row_table(self, row: int) -> KmerTable:
        if self._tables is None:
            self._fetch_all()
        return self._tables[row]

    def table(self) -> KmerTable:
        assert self._n_files == 1
        return self.row_table(0)


class _PendingSegments:
    """Result of one per-file-segment launch (ops.finalize
    count_kmers_packed_segments): every file's (words, counts, n_out) comes
    from ONE program; a speculative prefix slice is dispatched immediately
    so the whole group costs a single host sync when no file overflows
    ``KmerCounter._SPEC_ROWS`` (the overwhelmingly common case)."""

    def __init__(self, counter, dev, min_count, seg_words, caps, flat, w_per):
        self._c = counter
        self._dev = dev
        self._min_count = min_count
        self._seg_words = seg_words
        self._caps = caps
        self._w_per = w_per
        n_files = len(caps)
        stride = w_per + 2
        self._n_outs = [flat[f * stride + stride - 1] for f in range(n_files)]
        self._cols = [
            flat[f * stride : f * stride + w_per + 1] for f in range(n_files)
        ]
        spec_in: list = []
        for cols in self._cols:
            spec_in.extend(cols)
        self._spec = _take_prefix(
            tuple(spec_in), m=KmerCounter._SPEC_ROWS
        )
        self._tables: list[KmerTable] | None = None

    def prefetch(self) -> None:
        for n in self._n_outs:
            _async_to_host(n)
        for a in self._spec:
            _async_to_host(a)

    def _fetch_arrays(self) -> tuple:
        """Device arrays one host roundtrip resolves (see fetch_tables)."""
        return tuple(self._n_outs) + tuple(self._spec)

    def _fetch_all(self, fetched=None) -> None:
        from mercat2_tpu.ops.finalize import count_kmers_packed_segments

        c = self._c
        if fetched is None:
            fetched = jax.device_get(self._fetch_arrays())
        n_files = len(self._caps)
        n_outs = [int(v) for v in fetched[:n_files]]
        spec = fetched[n_files:]

        over = [f for f in range(n_files) if n_outs[f] > self._caps[f]]
        if over:  # output capacity overflow: rerun with room (rare)
            caps = tuple(
                _bucket_size(n_outs[f]) if f in over else self._caps[f]
                for f in range(n_files)
            )
            flat = count_kmers_packed_segments(
                *self._dev, jnp.int32(self._min_count),
                k=c.k, bits=c.codec.bits, alphabet_size=c.codec.size,
                seg_words=self._seg_words, caps=caps,
            )
            stride = self._w_per + 2
            self._caps = caps
            self._n_outs = [
                flat[f * stride + stride - 1] for f in range(n_files)
            ]
            self._cols = [
                flat[f * stride : f * stride + self._w_per + 1]
                for f in range(n_files)
            ]
            n_outs = [int(v) for v in jax.device_get(tuple(self._n_outs))]

        tables: list[KmerTable] = []
        w1 = self._w_per + 1
        for f in range(n_files):
            n = n_outs[f]
            m_have = min(self._caps[f], KmerCounter._SPEC_ROWS)
            if n <= m_have and not over:
                cols = [a[:n] for a in spec[f * w1 : (f + 1) * w1]]
            else:  # speculative miss: fetch this file's full prefix
                m = min(self._caps[f], max(512, 1 << max(n - 1, 1).bit_length()))
                cols = [
                    a[:n] for a in jax.device_get(
                        _take_prefix(tuple(self._cols[f]), m=m)
                    )
                ]
            tables.append(_sorted_table(c, cols[:-1], cols[-1], n))
        self._tables = tables
        self._dev = None

    def row_table(self, row: int) -> KmerTable:
        if self._tables is None:
            self._fetch_all()
        return self._tables[row]


class _PendingDenseSegments:
    """Result of one one-hot dense-histogram launch (ops.mxu_hist
    count_kmers_dense_segments): one small int32[S**k] histogram per file;
    min-count filter + decode happen on host at fetch time (the whole
    group's transfer is a few KB per file)."""

    def __init__(self, counter, hists, min_count):
        self._c = counter
        self._hists = hists
        self._min_count = min_count
        self._tables: list[KmerTable] | None = None

    def prefetch(self) -> None:
        for h in self._hists:
            _async_to_host(h)

    def _fetch_arrays(self) -> tuple:
        """Device arrays one host roundtrip resolves (see fetch_tables)."""
        return tuple(self._hists)

    def _fetch_all(self, fetched=None) -> None:
        from mercat2_tpu.ops.mxu_hist import decode_dense_histogram

        if fetched is None:
            fetched = jax.device_get(tuple(self._hists))
        self._tables = [
            decode_dense_histogram(h, self._c.k, self._c.codec,
                                   self._min_count)
            for h in fetched
        ]

    def row_table(self, row: int) -> KmerTable:
        if self._tables is None:
            self._fetch_all()
        return self._tables[row]


class _MultiView(PendingCount):
    """One file's slice of a combined multi-file launch."""

    def __init__(self, multi, row: int):
        self._multi = multi
        self._row = row

    def prefetch(self) -> None:
        self._multi.prefetch()

    def table(self) -> KmerTable:
        return self._multi.row_table(self._row)


class _PendingMultiSorted:
    """Result of one fid-tagged combined launch (ops.finalize
    count_kmers_multi_device); splits rows per file at fetch time."""

    def __init__(self, counter, dstream, dstarts, min_count, cap,
                 mode, shift, n_files, words, counts, n_out):
        self._c = counter
        self._dstream = dstream
        self._dstarts = dstarts
        self._min_count = min_count
        self._cap = cap
        self._mode = mode
        self._shift = shift
        self._n_files = n_files
        self._out = (words, counts, n_out)
        self._tables: list[KmerTable] | None = None

    def prefetch(self) -> None:
        _async_to_host(self._out[2])

    def _fetch_all(self) -> None:
        from mercat2_tpu.ops.finalize import count_kmers_multi_device

        c = self._c
        words, counts, n_out = self._out
        n_out = int(n_out)
        while n_out > self._cap:  # overflow: retry with room (rare)
            self._cap = _bucket_size(n_out)
            words, counts, n_out = count_kmers_multi_device(
                self._dstream, self._dstarts, jnp.int32(self._min_count),
                k=c.k, bits=c.codec.bits, alphabet_size=c.codec.size,
                cap=self._cap, n_files=self._n_files,
            )
            n_out = int(n_out)
        self._out = self._dstream = self._dstarts = None
        if n_out == 0:
            self._tables = [KmerTable.empty(c.k)] * self._n_files
            return
        m = min(self._cap, max(512, 1 << (n_out - 1).bit_length()))
        small = jax.device_get(_take_prefix(tuple(words) + (counts,), m=m))
        self._tables = _split_fid_tables(
            c, small, n_out, self._mode, self._shift, self._n_files
        )

    def row_table(self, row: int) -> KmerTable:
        if self._tables is None:
            self._fetch_all()
        return self._tables[row]


class NumpySource:
    """Packed-transport source backed by host numpy arrays.

    Mirrors the NativeFasta packed interface (packed_len / gap_ranges /
    fill_packed) for files parsed without the C++ library, and for tests.
    """

    def __init__(self, seq: np.ndarray, rec: np.ndarray, codec: Codec):
        self._codec = codec
        if seq.shape[0]:
            # drop empty records by construction: rec deltas > 1 mean empty
            # records between; gap scales with the delta like the C++ side
            boundary = np.empty(rec.shape[0], dtype=bool)
            boundary[0] = True
            np.not_equal(rec[1:], rec[:-1], out=boundary[1:])
            starts = np.flatnonzero(boundary)
            self._lens = np.diff(np.append(starts, rec.shape[0]))
            self._deltas = np.diff(rec[starts]).astype(np.int64)  # per gap
        else:
            self._lens = np.zeros(0, np.int64)
            self._deltas = np.zeros(0, np.int64)
        self._codes = codec.encode(seq)

    def packed_len(self, gap: int) -> int:
        if self._lens.size == 0:
            return 0
        return int(self._codes.shape[0] + self._deltas.sum() * gap)

    def gap_ranges(self, gap: int) -> tuple[np.ndarray, np.ndarray]:
        if self._lens.size <= 1:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        gaps = self._deltas * gap
        ends_of_rec = np.cumsum(self._lens[:-1] + gaps) - gaps
        return ends_of_rec, ends_of_rec + gaps

    def gapped_codes(self, gap: int) -> np.ndarray:
        """uint8 code stream with `gap*delta` zero symbols between records."""
        total = self.packed_len(gap)
        out = np.zeros(total, np.uint8)
        if self._lens.size == 0:
            return out
        gaps = self._deltas * gap
        starts = np.concatenate(
            [[0], np.cumsum(self._lens[:-1] + gaps)]
        ).astype(np.int64)
        src = 0
        for s, ln in zip(starts, self._lens):
            out[s : s + ln] = self._codes[src : src + ln]
            src += ln
        return out

    def fill_packed(self, bits: int, gap: int, lut256_unused, words: np.ndarray,
                    sym_off: int) -> int:
        codes = self.gapped_codes(gap)
        pack_codes_into(codes, words, sym_off, bits)
        return codes.shape[0]

    def close(self) -> None:
        pass


def pack_codes_into(codes: np.ndarray, words: np.ndarray, sym_off: int,
                    bits: int) -> None:
    """Big-endian bit-pack uint8 codes into a zeroed uint32 word buffer at
    symbol offset ``sym_off`` (must be a multiple of 32//bits)."""
    per = 32 // bits
    assert sym_off % per == 0
    n = codes.shape[0]
    if n == 0:
        return
    w0 = sym_off // per
    nw = -(-n // per)
    mat = np.zeros((nw, per), np.uint32)
    mat.reshape(-1)[:n] = codes
    shifts = (32 - bits * (np.arange(per) + 1)).astype(np.uint32)
    np.bitwise_or.reduce(mat << shifts, axis=1, out=words[w0 : w0 + nw])


@dataclasses.dataclass
class PackedGroup:
    """Host-assembled transport buffer for one multi-file device launch."""

    words: np.ndarray        # uint32[n_sym // per], big-endian packed codes
    n_sym: int               # padded symbol count (bucket size)
    file_starts: np.ndarray  # int32[n_files], symbol offset of each file
    gap_begin: np.ndarray    # int32[G], half-open no-window symbol ranges
    gap_end: np.ndarray      # (record gaps, inter-file gaps, tail padding)
    content_end: int = 0     # symbols before the tail bucket padding


class KmerCounter:
    """Reusable counter for a fixed (k, codec).

    Sharing one counter across the chunks of a sample keeps the codec (and
    therefore the compiled kernel) stable, so numeric keys from different
    chunks are directly comparable/mergeable. Passing a shared ``bucket``
    (power-of-two stream size covering the largest file of a batch) keeps
    the whole batch on ONE compiled program.
    """

    def __init__(self, k: int, codec: Codec):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.codec = codec

    # -- stream building ---------------------------------------------------

    def stream_len(self, seq: np.ndarray, rec: np.ndarray) -> int:
        """Unpadded length of the separator-delimited code stream."""
        n = seq.shape[0]
        if n == 0:
            return 0
        gap = self.k - 1
        rel = int(rec[-1]) - int(rec[0])
        return n + rel * gap

    def build_stream(
        self, seq: np.ndarray, rec: np.ndarray, bucket: int | None = None
    ) -> np.ndarray:
        """Sequence bytes + record ids -> padded uint8 code stream.

        Consecutive records are separated by k-1 sentinel codes so no window
        spans a record boundary; the tail is sentinel-padded to the bucket
        (``bucket`` may force a larger size to share one compiled shape
        across files).
        """
        codes = self.codec.encode(seq)
        gap = self.k - 1
        n = codes.shape[0]
        if n == 0:
            total = 0
        elif gap == 0:
            total = n
            pos = None
        else:
            # rank of each byte's record among the records present
            rel = (rec - rec[0]).astype(np.int64)
            pos = np.arange(n, dtype=np.int64) + rel * gap
            total = int(pos[-1]) + 1
        size = _bucket_size(max(total, self.k))
        if bucket is not None:
            size = max(size, bucket)
        padded = np.full(size, self.codec.sentinel, np.uint8)
        if n:
            if gap == 0:
                padded[:n] = codes
            else:
                padded[pos] = codes
        return padded

    # -- device + finalize -------------------------------------------------

    def _keyspace(self) -> int:
        """S**k, capped: an output table can never have more rows."""
        if self.k * self.codec.bits > 30:
            return 1 << 62
        return min(self.codec.size**self.k, 1 << 62)

    def dispatch_stream(self, stream: np.ndarray, min_count: int = 1) -> "PendingCount":
        """Enqueue the device count for one padded stream, without blocking.

        JAX dispatch is asynchronous: this returns as soon as the transfer
        and compute are queued, so callers can pipeline host-side stream
        building of file i+1 with device compute of file i (the device
        equivalent of the reference's per-chunk Ray task overlap,
        /root/reference/bin/mercat2.py:118-127). Call ``.table()`` on the
        result to fetch the finished :class:`KmerTable`.
        """
        n = stream.shape[0]
        size = _bucket_size(max(n, self.k))
        if size != n:  # raw (trimmed) input: bucket-pad here
            padded = np.full(size, self.codec.sentinel, np.uint8)
            padded[:n] = stream
            stream = padded

        from mercat2_tpu.ops.finalize import count_kmers_device

        p = stream.shape[0] - self.k + 1
        cap = min(p, self._keyspace())
        if min_count > 1:
            cap = min(cap, _DEFAULT_CAP)
        dstream = jnp.asarray(stream)
        words, counts, n_out = count_kmers_device(
            dstream,
            jnp.int32(min_count),
            k=self.k,
            bits=self.codec.bits,
            alphabet_size=self.codec.size,
            cap=cap,
        )
        return _PendingSorted(self, dstream, min_count, cap, words, counts, n_out)

    #: streams at least this long get their own launch instead of joining
    #: a fid-tagged multi-file launch. Not measured on the H100.
    _SOLO_MIN = 2 << 20
    #: target combined size per multi launch (small-file groups)
    _MULTI_TARGET = 6 << 20

    def dispatch_streams(self, streams: list, min_count: int = 1) -> list:
        """Dispatch several streams; one PendingCount each, in order.

        Small streams are concatenated (k-1 sentinel gap between files) and
        counted in ONE device launch with file-id-tagged sort keys (see
        ops.finalize.count_kmers_multi_device), so per-launch overhead
        does not dominate them. Large streams launch solo.
        """
        streams = list(streams)
        if len(streams) == 1:
            return [self.dispatch_stream(streams[0], min_count)]
        trimmed = [_trim_sentinels(s, self.codec.sentinel) for s in streams]
        results: list = [None] * len(streams)
        group: list[int] = []
        group_bytes = 0

        def flush() -> None:
            nonlocal group, group_bytes
            if not group:
                return
            if len(group) == 1:
                results[group[0]] = self.dispatch_stream(
                    trimmed[group[0]], min_count
                )
            else:
                multi = self._dispatch_multi(
                    [trimmed[i] for i in group], min_count
                )
                for r, i in enumerate(group):
                    results[i] = _MultiView(multi, r)
            group, group_bytes = [], 0

        for i, t in enumerate(trimmed):
            if t.shape[0] >= self._SOLO_MIN:
                results[i] = self.dispatch_stream(t, min_count)
                continue
            if group and group_bytes + t.shape[0] > self._MULTI_TARGET:
                flush()
            group.append(i)
            group_bytes += t.shape[0]
        flush()
        return results

    def _combine_streams(self, streams: list) -> tuple[np.ndarray, np.ndarray]:
        """Concatenate trimmed streams with k-1 sentinel gaps, bucket-pad."""
        gap = self.k - 1
        trimmed = streams  # already trimmed by dispatch_streams
        total = sum(t.shape[0] for t in trimmed) + gap * (len(trimmed) - 1)
        size = _bucket_size(max(total, self.k))
        combined = np.full(size, self.codec.sentinel, np.uint8)
        starts = np.empty(len(trimmed), np.int32)
        off = 0
        for f, t in enumerate(trimmed):
            starts[f] = off
            combined[off : off + t.shape[0]] = t
            off += t.shape[0] + gap
        return combined, starts

    def _dispatch_multi(self, streams: list, min_count: int):
        combined, starts = self._combine_streams(streams)
        dstream = jnp.asarray(combined)
        dstarts = jnp.asarray(starts)
        n_files = len(streams)

        from mercat2_tpu.ops.finalize import (
            count_kmers_multi_device, fid_layout,
        )

        p = combined.shape[0] - self.k + 1
        cap = min(p, n_files * self._keyspace())
        if min_count > 1:
            cap = min(cap, max(_DEFAULT_CAP, 16384 * n_files))
        mode, shift = fid_layout(self.k, self.codec.bits, n_files)
        words, counts, n_out = count_kmers_multi_device(
            dstream, dstarts, jnp.int32(min_count),
            k=self.k, bits=self.codec.bits, alphabet_size=self.codec.size,
            cap=cap, n_files=n_files,
        )
        return _PendingMultiSorted(
            self, dstream, dstarts, min_count, cap, mode, shift,
            n_files, words, counts, n_out,
        )

    # -- packed transport (bit-packed h2d; the default when bits | 32) -----

    def packable(self) -> bool:
        """True when the bit-packed transport saves h2d bytes.

        ``per = 32 // bits`` symbols ride each uint32 word (the word's low
        ``32 - per*bits`` bits stay zero when bits does not divide 32, e.g.
        5-bit protein codes pack 6 per word = 5.33 effective bits/symbol vs
        8 for the uint8 stream). bits > 6 gives per <= 4, i.e. >= 8 bits
        per symbol — no cheaper than the plain stream, so not packed.
        """
        return self.codec.bits <= 6

    #: target combined symbols per packed launch group. Segments sort
    #: per-file inside one program, so group size trades h2d pipelining
    #: against fixed per-launch overhead (launch latency + per-group sync).
    #: Not measured on the H100.
    _PACK_TARGET = 18 << 20

    def source_for(self, path, nf=None):
        """Packed-transport source for one file: native handle or numpy."""
        if nf is not None:
            return nf
        from mercat2_tpu.io.native import open_fasta_native

        try:
            nf = open_fasta_native(path)
        except OSError:
            nf = None
        if nf is not None:
            return nf
        from mercat2_tpu.io.fasta import parse_fasta_seq

        seq, rec = parse_fasta_seq(path)
        return NumpySource(seq, rec, self.codec)

    def build_packed_group(self, sources: list, bucket: int | None = None,
                           workers: int | None = None,
                           gap_slots: int | None = None) -> PackedGroup | None:
        """Assemble one transport buffer for several files.

        File segments are word-aligned (so the native fillers write disjoint
        uint32s and can run in parallel threads) and separated by >= 1 gap
        symbol; record gaps, inter-file gaps and tail padding all become gap
        ranges for the device-side validity mask. Returns None when no file
        contributes a window. ``gap_slots`` forces the padded gap-array
        length (callers of the fixed-shape uniform path must guarantee the
        real gap count fits); default pads to the next power of two.
        """
        from concurrent.futures import ThreadPoolExecutor

        per = 32 // self.codec.bits
        gap = _REC_GAP
        lens = [s.packed_len(gap) for s in sources]
        offs: list[int] = []
        inter: list[tuple[int, int]] = []
        off = 0
        for i, length in enumerate(lens):
            offs.append(off)
            end = off + length
            if i < len(lens) - 1:
                noff = -(-(end + 1) // per) * per  # >=1 gap symbol, aligned
                inter.append((end, noff))
                off = noff
            else:
                off = end
        total = off
        if total < self.k:
            return None
        if gap_slots is not None:
            # fixed-shape (uniform) path: the bucket IS the shape
            assert bucket is not None and total <= bucket, (total, bucket)
            size = bucket
        else:
            size = _bucket_size(total)
            if bucket is not None:
                size = max(size, bucket)
        size = -(-size // per) * per  # whole words (bits may not divide 32)
        words = np.zeros(size // per, np.uint32)
        lut = self.codec.lut_encode()

        def fill(i: int) -> None:
            sources[i].fill_packed(self.codec.bits, gap, lut, words, offs[i])

        if len(sources) > 1 and workers != 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(fill, range(len(sources))))
        else:
            for i in range(len(sources)):
                fill(i)

        gb: list[np.ndarray] = []
        ge: list[np.ndarray] = []
        for i, s in enumerate(sources):
            b, e = s.gap_ranges(gap)
            gb.append(np.asarray(b, np.int64) + offs[i])
            ge.append(np.asarray(e, np.int64) + offs[i])
        if inter:
            b, e = zip(*inter)
            gb.append(np.asarray(b, np.int64))
            ge.append(np.asarray(e, np.int64))
        gb.append(np.asarray([total], np.int64))
        ge.append(np.asarray([size], np.int64))
        gap_begin = np.concatenate(gb)
        gap_end = np.concatenate(ge)
        # pad the gap arrays to a power of two (>= 16) so a handful of
        # compiled shapes cover every dataset; pads clamp to no-ops
        if gap_slots is None:
            g = max(16, 1 << (int(gap_begin.shape[0]) - 1).bit_length())
        else:
            g = gap_slots
            assert gap_begin.shape[0] <= g, (gap_begin.shape[0], g)
        pad = g - gap_begin.shape[0]
        noop = size + self.k
        gap_begin = np.concatenate([gap_begin, np.full(pad, noop)])
        gap_end = np.concatenate([gap_end, np.full(pad, noop)])
        return PackedGroup(
            words=words,
            n_sym=size,
            file_starts=np.asarray(offs, np.int32),
            gap_begin=gap_begin.astype(np.int32),
            gap_end=gap_end.astype(np.int32),
            content_end=total,
        )

    def build_packed_group_segmented(self, sources: list) -> PackedGroup | None:
        """Like :meth:`build_packed_group`, but each file's segment is padded
        to its own eighth-pow2 symbol bucket (word-aligned), so the static
        per-file segment shapes of ``count_kmers_packed_segments`` come from
        a small bucketed family. Padding symbols are covered by gap ranges.
        """
        from concurrent.futures import ThreadPoolExecutor

        per = 32 // self.codec.bits
        gap = _REC_GAP
        lens = [s.packed_len(gap) for s in sources]
        offs: list[int] = []
        seg_ends: list[int] = []
        off = 0
        for length in lens:
            offs.append(off)
            bucket = _bucket_size(max(length + 1, self.k + 1))
            bucket = -(-bucket // per) * per
            seg_ends.append(off + bucket)
            off += bucket
        size = off
        words = np.zeros(size // per, np.uint32)
        lut = self.codec.lut_encode()

        def fill(i: int) -> None:
            sources[i].fill_packed(self.codec.bits, gap, lut, words, offs[i])

        if len(sources) > 1:
            with ThreadPoolExecutor() as pool:
                list(pool.map(fill, range(len(sources))))
        else:
            fill(0)

        gb: list[np.ndarray] = []
        ge: list[np.ndarray] = []
        for i, s in enumerate(sources):
            b, e = s.gap_ranges(gap)
            gb.append(np.asarray(b, np.int64) + offs[i])
            ge.append(np.asarray(e, np.int64) + offs[i])
            # per-file tail padding [content end, bucket end)
            gb.append(np.asarray([offs[i] + lens[i]], np.int64))
            ge.append(np.asarray([seg_ends[i]], np.int64))
        gap_begin = np.concatenate(gb)
        gap_end = np.concatenate(ge)
        g = max(16, 1 << (int(gap_begin.shape[0]) - 1).bit_length())
        pad = g - gap_begin.shape[0]
        noop = size + self.k
        gap_begin = np.concatenate([gap_begin, np.full(pad, noop)])
        gap_end = np.concatenate([gap_end, np.full(pad, noop)])
        return PackedGroup(
            words=words,
            n_sym=size,
            file_starts=np.asarray(offs, np.int32),
            gap_begin=gap_begin.astype(np.int32),
            gap_end=gap_end.astype(np.int32),
        ), tuple(
            (offs[i] // per, seg_ends[i] // per) for i in range(len(sources))
        )

    #: speculative rows fetched per file before n_out is known (one host
    #: roundtrip covers n_out AND the table when n_out <= this; misses
    #: trigger a second fetch for the affected files only). 1024 rows hit
    #: as often as 8192 on genomic min-count tables for 8x fewer d2h bytes;
    #: the d2h time this saves is not measured on the H100.
    _SPEC_ROWS = 1024
    #: speculative prefix rows for packed (multi-file fid-tagged) launches:
    #: a launch aggregates up to 32 files' tables, so its n_out runs larger
    #: than a per-file segment's
    _SPEC_ROWS_PACKED = 8192

    #: use the one-hot matmul histogram for keyspaces up to MXU_MAX_BINS
    #: (ops.mxu_hist). Whether it beats the sort path on the H100 is not
    #: measured. Flip to False to force sorting.
    _DENSE_SMALL_K = True

    def dispatch_packed_segments(self, sources: list, min_count: int = 1,
                                 engine: str = "auto"):
        """One launch, ONE host sync for the whole group. Per-file segments
        are sorted — or, for small keyspaces, binned by one-hot matmuls
        (``engine``: "auto" | "sort" | "dense"). Returns list[PendingCount].
        """
        from mercat2_tpu.ops.finalize import count_kmers_packed_segments
        from mercat2_tpu.ops.mxu_hist import MXU_MAX_BINS

        built = self.build_packed_group_segmented(sources)
        if built is None:
            return [_EmptyPending(self.k) for _ in sources]
        group, seg_words = built
        per = 32 // self.codec.bits
        use_dense = engine == "dense" or (
            engine == "auto" and self._DENSE_SMALL_K
            and self._keyspace() <= MXU_MAX_BINS
        )
        if use_dense:
            from mercat2_tpu.ops.mxu_hist import count_kmers_dense_segments

            hists = count_kmers_dense_segments(
                jnp.asarray(group.words),
                jnp.asarray(group.gap_begin),
                jnp.asarray(group.gap_end),
                k=self.k, bits=self.codec.bits,
                alphabet_size=self.codec.size, seg_words=seg_words,
            )
            multi = _PendingDenseSegments(self, hists, min_count)
            return [_MultiView(multi, i) for i in range(len(sources))]
        caps = []
        for w0, w1 in seg_words:
            p = (w1 - w0) * per - self.k + 1
            cap = min(p, self._keyspace())
            if min_count > 1:
                cap = min(cap, _DEFAULT_CAP)
            caps.append(cap)
        caps = tuple(caps)
        dev = (
            jnp.asarray(group.words),
            jnp.asarray(group.gap_begin),
            jnp.asarray(group.gap_end),
        )
        flat = count_kmers_packed_segments(
            *dev, jnp.int32(min_count),
            k=self.k, bits=self.codec.bits,
            alphabet_size=self.codec.size,
            seg_words=seg_words, caps=caps,
        )
        w_per = len(flat) // len(sources) - 2  # words..., counts, n_out
        multi = _PendingSegments(
            self, dev, min_count, seg_words, caps, flat, w_per
        )
        return [_MultiView(multi, i) for i in range(len(sources))]

    def dispatch_packed(self, group: PackedGroup, min_count: int = 1):
        """Enqueue the device count of one packed group (non-blocking)."""
        from mercat2_tpu.ops.finalize import count_kmers_packed, fid_layout

        n_files = int(group.file_starts.shape[0])
        p = group.n_sym - self.k + 1
        cap = min(p, n_files * self._keyspace())
        if min_count > 1:
            cap = min(cap, max(_DEFAULT_CAP, 16384 * n_files))
        if n_files == 1:
            mode, shift = "none", 0
        else:
            mode, shift = fid_layout(self.k, self.codec.bits, n_files)
        dev = (
            jnp.asarray(group.words),
            jnp.asarray(group.gap_begin),
            jnp.asarray(group.gap_end),
            jnp.asarray(group.file_starts),
        )
        words, counts, n_out = count_kmers_packed(
            *dev, jnp.int32(min_count),
            k=self.k, bits=self.codec.bits, alphabet_size=self.codec.size,
            cap=cap, n_files=n_files, n_sym=group.n_sym,
        )
        return _PendingPacked(
            self, dev, min_count, cap, mode, shift, n_files, group.n_sym,
            words, counts, n_out,
        )

    # -- uniform fixed-shape launches (pipeline path) ----------------------

    #: fixed transport shape family for :meth:`dispatch_packed_uniform`.
    #: One (k, codec) pair compiles exactly ONE device program for a whole
    #: pipeline run, at the price of some sort padding per launch. 12M
    #: symbols fits any chunk up to ~11.5 MB (the reference benchmark
    #: chunks at -s 10; larger chunks fall back to the adaptive
    #: dispatchers); compile time and compile memory both grow with the
    #: sort rows. Whether the fixed shape still pays with a persistent
    #: compile cache is not measured on the H100.
    _UNIFORM_SYMS = 12 << 20
    _UNIFORM_FILES = 32
    _UNIFORM_GAPS = 1 << 17
    _UNIFORM_CAP = 1 << 19

    #: size families for the uniform program, smallest first. XLA compile
    #: time and compile memory grow with the sort row count, so rounds
    #: whose files all fit the small family (e.g. the ~1.5M-residue ORF
    #: protein outputs of the reference pipeline) compile a cheaper
    #: program; the large family remains the general bound (fits_uniform).
    _UNIFORM_FAMILIES = (4 << 20, 8 << 20, 12 << 20)

    def _uniform_family(self, lens: list[int]) -> int | None:
        """Smallest family every packed length fits, or None when even the
        cap (_UNIFORM_SYMS, the largest family) cannot hold some file."""
        per = 32 // self.codec.bits
        need = max(lens, default=0) + per
        for f in self._UNIFORM_FAMILIES:
            if f < self._UNIFORM_SYMS and need <= f:
                return f
        return self._UNIFORM_SYMS if need <= self._UNIFORM_SYMS else None

    #: gap-slot families, smallest first: padded to the full 2^17 the two
    #: gap arrays cost ~1 MB of h2d per launch, about a quarter of the
    #: packed bytes of a genome launch that uses a few dozen slots. Contig
    #: rounds fit 2^12, ORF protein rounds (one gap per gene) 2^14; reads
    #: data keeps the full bound.
    _UNIFORM_GAP_FAMILIES = (1 << 12, 1 << 14, 1 << 17)

    def _uniform_gap_family(self, gapbs: list[int]) -> int | None:
        """Smallest gap-slot family every file's gap bound fits alone."""
        need = max(gapbs, default=0) + 2
        for f in self._UNIFORM_GAP_FAMILIES:
            if f < self._UNIFORM_GAPS and need <= f:
                return f
        return self._UNIFORM_GAPS if need <= self._UNIFORM_GAPS else None

    def _uniform_n_sym(self, syms: int | None = None) -> int:
        per = 32 // self.codec.bits
        return -(-(syms or self._UNIFORM_SYMS) // per) * per

    @staticmethod
    def _gap_bound(source) -> int:
        """Upper bound on the gap ranges one source contributes."""
        n = getattr(source, "num_records", None)
        if n is None:
            n = getattr(source, "_lens", np.zeros(0)).shape[0]
        return int(n) + 2

    def dispatch_packed_fixed(self, group: PackedGroup, min_count: int,
                              n_real_files: int):
        """Enqueue one uniform-shape fid-tagged launch (see
        :meth:`dispatch_packed_uniform`). ``group`` must have the fixed
        ``_uniform_n_sym`` symbol count and ``_UNIFORM_GAPS`` gap slots;
        ``file_starts`` is padded here to ``_UNIFORM_FILES`` entries."""
        from mercat2_tpu.ops.finalize import count_kmers_packed, fid_layout

        n_files = self._UNIFORM_FILES
        starts = np.full(n_files, group.n_sym, np.int32)
        starts[:n_real_files] = group.file_starts
        cap = self._UNIFORM_CAP
        mode, shift = fid_layout(self.k, self.codec.bits, n_files)
        dev = (
            jnp.asarray(group.words),
            jnp.asarray(group.gap_begin),
            jnp.asarray(group.gap_end),
            jnp.asarray(starts),
        )
        words, counts, n_out = count_kmers_packed(
            *dev, jnp.int32(min_count),
            k=self.k, bits=self.codec.bits, alphabet_size=self.codec.size,
            cap=cap, n_files=n_files, n_sym=group.n_sym,
        )
        return _PendingPacked(
            self, dev, min_count, cap, mode, shift, n_files, group.n_sym,
            words, counts, n_out,
        )

    #: files (= dense histogram segments) per launch of the dense uniform
    #: program; each occupies its own fixed _UNIFORM_SYMS-symbol slot
    _UNIFORM_DENSE_SLOTS = 2

    def _dispatch_uniform_dense(
        self, sources: list, min_count: int, workers: int | None = None,
        family: int | None = None, gap_family: int | None = None,
    ) -> list[PendingCount] | None:
        """Fixed-shape one-hot histogram launches (small keyspaces).

        One file per fixed _UNIFORM_SYMS-symbol slot, _UNIFORM_DENSE_SLOTS
        slots per launch, every launch the SAME compiled program — the
        sort-free sibling of :meth:`dispatch_packed_uniform` (a dense
        program compiles faster than one containing a _UNIFORM_SYMS-row
        sort).
        """
        from concurrent.futures import ThreadPoolExecutor

        from mercat2_tpu.ops.mxu_hist import count_kmers_dense_segments

        per = 32 // self.codec.bits
        gap = _REC_GAP
        lens = [s.packed_len(gap) for s in sources]
        fam_auto = self._uniform_family(lens)
        if fam_auto is None:
            return None
        family = min(max(family or 0, fam_auto), self._UNIFORM_SYMS)
        n_sym = self._uniform_n_sym(family)
        slots = self._UNIFORM_DENSE_SLOTS
        gapbs = [self._gap_bound(s) for s in sources]
        gf_auto = self._uniform_gap_family([b * slots for b in gapbs])
        if gf_auto is None:
            return None
        gap_family = min(max(gap_family or 0, gf_auto), self._UNIFORM_GAPS)
        if any(b > gap_family // slots - 2 for b in gapbs):
            return None
        seg_words = tuple(
            (i * (n_sym // per), (i + 1) * (n_sym // per))
            for i in range(slots)
        )
        lut = self.codec.lut_encode()
        noop = slots * n_sym + self.k

        results: list[PendingCount] = [None] * len(sources)  # type: ignore
        for g0 in range(0, len(sources), slots):
            batch = sources[g0 : g0 + slots]
            words = np.zeros(slots * (n_sym // per), np.uint32)

            def fill(i: int) -> None:
                batch[i].fill_packed(
                    self.codec.bits, gap, lut, words, i * n_sym
                )

            if len(batch) > 1 and workers != 1:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    list(pool.map(fill, range(len(batch))))
            else:
                for i in range(len(batch)):
                    fill(i)

            gb: list[np.ndarray] = []
            ge: list[np.ndarray] = []
            for i in range(slots):
                off = i * n_sym
                if i < len(batch):
                    b, e = batch[i].gap_ranges(gap)
                    gb.append(np.asarray(b, np.int64) + off)
                    ge.append(np.asarray(e, np.int64) + off)
                    gb.append(np.asarray([off + lens[g0 + i]], np.int64))
                else:  # empty slot: fully masked
                    gb.append(np.asarray([off], np.int64))
                ge.append(np.asarray([off + n_sym], np.int64))
            gap_begin = np.concatenate(gb)
            gap_end = np.concatenate(ge)
            pad = gap_family - gap_begin.shape[0]
            gap_begin = np.concatenate([gap_begin, np.full(pad, noop)])
            gap_end = np.concatenate([gap_end, np.full(pad, noop)])

            hists = count_kmers_dense_segments(
                jnp.asarray(words),
                jnp.asarray(gap_begin.astype(np.int32)),
                jnp.asarray(gap_end.astype(np.int32)),
                k=self.k, bits=self.codec.bits,
                alphabet_size=self.codec.size, seg_words=seg_words,
            )
            multi = _PendingDenseSegments(self, hists, min_count)
            multi.prefetch()
            for i in range(len(batch)):
                results[g0 + i] = _MultiView(multi, i)
        return results

    def fits_uniform(self, source) -> bool:
        """True when ``source`` fits the fixed uniform transport shape, i.e.
        :meth:`dispatch_packed_uniform` cannot return None for it. Lets the
        pipeline pre-check files one at a time (bounded inflight window)
        instead of building every source up-front to learn the answer."""
        from mercat2_tpu.ops.mxu_hist import MXU_MAX_BINS

        per = 32 // self.codec.bits
        length = source.packed_len(_REC_GAP)
        b = self._gap_bound(source)
        if (
            self._DENSE_SMALL_K
            and self._keyspace() <= MXU_MAX_BINS
            and length + per <= self._UNIFORM_SYMS
            and b <= self._UNIFORM_GAPS // self._UNIFORM_DENSE_SLOTS - 2
        ):
            return True  # dense sibling accepts it
        return length + per <= self._UNIFORM_SYMS and b <= self._UNIFORM_GAPS - 2

    def dispatch_packed_uniform(
        self, sources: list, min_count: int = 1, workers: int | None = None,
        family: int | None = None, gap_family: int | None = None,
    ) -> list[PendingCount] | None:
        """Count all sources through ONE compiled program shape.

        Files are greedy-packed into fixed-symbol fid-tagged transport
        buffers (<= 32 files; the symbol and gap-slot counts are the
        smallest _UNIFORM_FAMILIES / _UNIFORM_GAP_FAMILIES entries every
        source fits) and every buffer runs the SAME compiled
        ``count_kmers_packed`` program — the count path for pipeline runs,
        which keeps the number of compiled programs per run small. Small
        keyspaces route to the sort-free dense sibling
        (:meth:`_dispatch_uniform_dense`). Returns one PendingCount per
        source, or None when some source does not fit the fixed shape
        (caller falls back to the adaptive-shape dispatchers).
        """
        from mercat2_tpu.ops.mxu_hist import MXU_MAX_BINS

        if self._DENSE_SMALL_K and self._keyspace() <= MXU_MAX_BINS:
            dense = self._dispatch_uniform_dense(
                sources, min_count, workers, family, gap_family
            )
            if dense is not None:
                return dense
        gap = _REC_GAP
        per = 32 // self.codec.bits
        lens = [s.packed_len(gap) for s in sources]
        gapb = [self._gap_bound(s) for s in sources]
        # caller-pinned families (from prewarm / round-level estimates)
        # are upgraded, never trusted blindly: every source must fit
        fam_auto = self._uniform_family(lens)
        if fam_auto is None:  # exceeds the largest family -> adaptive path
            return None
        family = min(max(family or 0, fam_auto), self._UNIFORM_SYMS)
        n_sym = self._uniform_n_sym(family)
        gf_auto = self._uniform_gap_family(gapb)
        if gf_auto is None:
            return None
        gap_family = min(max(gap_family or 0, gf_auto), self._UNIFORM_GAPS)
        # word-aligned usable capacity mirrors build_packed_group layout:
        # each file's segment is padded to whole words plus one gap symbol.
        # Capped at the family size exactly (not the word-rounded n_sym) so
        # the content total always buckets to <= n_sym inside
        # build_packed_group.
        usable = family

        groups: list[list[int]] = []
        cur: list[int] = []
        cur_sym = cur_gaps = 0
        for i, (length, b) in enumerate(zip(lens, gapb)):
            seg = -(-(length + 1) // per) * per  # segment incl. alignment gap
            if cur and (
                cur_sym + seg > usable
                or len(cur) >= self._UNIFORM_FILES
                or cur_gaps + b > gap_family - 2
            ):
                groups.append(cur)
                cur, cur_sym, cur_gaps = [], 0, 0
            cur.append(i)
            cur_sym += seg
            cur_gaps += b
        if cur:
            groups.append(cur)

        results: list[PendingCount] = [None] * len(sources)  # type: ignore
        for g in groups:
            subset = [sources[i] for i in g]
            built = self.build_packed_group(
                subset, bucket=n_sym, workers=workers,
                gap_slots=gap_family,
            )
            if built is None:
                for i in g:
                    results[i] = _EmptyPending(self.k)
                continue
            assert built.n_sym == n_sym, (built.n_sym, n_sym)
            pending = self.dispatch_packed_fixed(built, min_count, len(g))
            pending.prefetch()
            for r, i in enumerate(g):
                results[i] = _MultiView(pending, r)
        return results

    #: max combined symbols per segmented launch. NOT a sort-size bound
    #: (segments sort separately inside the program) — this paces h2d /
    #: compute overlap against fixed per-launch overhead. Not measured on
    #: the H100.
    _SEG_TARGET = 18 << 20

    def dispatch_packed_sources(
        self, sources: list, min_count: int = 1, workers: int | None = None
    ) -> list[PendingCount]:
        """Dispatch all sources with as FEW launches as possible: one
        per-file-segment program per ~_SEG_TARGET symbols (each file sorted
        separately inside, and the whole group needs one launch + one host
        sync). The packed-path
        equivalent of the reference's per-chunk Ray task overlap
        (/root/reference/bin/mercat2.py:118-127)."""
        lens = [s.packed_len(_REC_GAP) for s in sources]
        target = self._SEG_TARGET
        groups: list[list[int]] = []
        cur: list[int] = []
        cur_sym = 0
        for i, length in enumerate(lens):
            if cur and cur_sym + length > target:
                groups.append(cur)
                cur, cur_sym = [], 0
            cur.append(i)
            cur_sym += length
        if cur:
            groups.append(cur)

        results: list[PendingCount] = [None] * len(sources)  # type: ignore
        for g in groups:
            pendings = self.dispatch_packed_segments(
                [sources[i] for i in g], min_count
            )
            for r, i in enumerate(g):
                results[i] = pendings[r]
                results[i].prefetch()
        return results

    def count_stream(self, stream: np.ndarray, min_count: int = 1) -> KmerTable:
        return self.dispatch_stream(stream, min_count).table()

    def count(
        self,
        seq: np.ndarray,
        rec: np.ndarray,
        min_count: int = 1,
        bucket: int | None = None,
    ) -> KmerTable:
        seq, rec = _drop_short_records(seq, rec, self.k)
        if seq.shape[0] < self.k:
            return KmerTable.empty(self.k)
        if self.k > _MAX_DEVICE_K:
            return _count_host(seq, rec, self.k, min_count)
        return self.count_stream(self.build_stream(seq, rec, bucket), min_count)

    def build_stream_native(self, nf, bucket: int | None = None) -> np.ndarray | None:
        """Padded code stream from a native parse handle, or None if empty.

        The C++ side encodes + gap-inserts directly into the padded stream
        buffer — no per-byte record-id array is ever materialized. Records
        shorter than k are kept (their windows are masked by the sentinel
        gaps), so results match :meth:`count` exactly. ctypes releases the
        GIL during the fill, so several files can build concurrently.
        """
        total = nf.stream_len(self.k)
        if total < self.k:
            return None
        size = _bucket_size(total)
        if bucket is not None:
            size = max(size, bucket)
        stream = np.full(size, self.codec.sentinel, np.uint8)
        nf.fill_stream(self.k, self.codec.lut_encode(), stream)
        return stream

    def count_native(self, nf, min_count: int = 1,
                     bucket: int | None = None) -> KmerTable:
        """Count from a native parse handle (io.native.NativeFasta)."""
        if self.k > _MAX_DEVICE_K:
            seq, rec = nf.seq_and_rec()
            seq, rec = _drop_short_records(seq, rec, self.k)
            if seq.shape[0] < self.k:
                return KmerTable.empty(self.k)
            return _count_host(seq, rec, self.k, min_count)
        stream = self.build_stream_native(nf, bucket)
        if stream is None:
            return KmerTable.empty(self.k)
        return self.count_stream(stream, min_count)


def count_file(path, k: int, min_count: int = 1, codec: Codec | None = None) -> KmerTable:
    """Count k-mers of one FASTA file (text or .gz), min-count filtered.

    Matches the reference's ``find_kmers`` semantics
    (/root/reference/lib/mercat2_kmers.py:32-78): raw case-sensitive k-mers,
    ``*`` stripped, per-record windows, filter applied per file. Uses the
    native C++ parse+encode path when built.
    """
    from mercat2_tpu.engine.codec import codec_for_alphabet
    from mercat2_tpu.io.native import open_fasta_native

    try:
        nf = open_fasta_native(path)
    except OSError:
        nf = None
    if nf is not None:
        with nf:
            codec = codec_for_alphabet(nf.alphabet(), prefer=codec)
            return KmerCounter(k, codec).count_native(nf, min_count)

    from mercat2_tpu.io.fasta import parse_fasta_seq

    seq, rec = parse_fasta_seq(path)
    codec = codec_for_bytes(seq, prefer=codec)
    return KmerCounter(k, codec).count(seq, rec, min_count)


def merge_tables(tables: list[KmerTable], k: int) -> KmerTable:
    """Sum counts of already-filtered per-file tables (driver-side reduce).

    Mirrors the reference's dict merge (/root/reference/bin/mercat2.py:121-127):
    the min-count filter has already been applied per file, so this is a
    plain sorted multiway sum.
    """
    tables = [t for t in tables if len(t)]
    if not tables:
        return KmerTable.empty(k)
    if len(tables) == 1:
        return tables[0]
    allk = np.concatenate([t.kmers for t in tables], axis=0)
    allc = np.concatenate([t.counts for t in tables], axis=0)
    # lexicographic sort of the byte rows: view as void records
    void = np.ascontiguousarray(allk).view([("", np.uint8)] * k).ravel()
    order = np.argsort(void, kind="stable")
    allk, allc = allk[order], allc[order]
    void = void[order]
    change = np.empty(len(void), dtype=bool)
    change[0] = True
    change[1:] = void[1:] != void[:-1]
    starts = np.flatnonzero(change)
    sums = np.add.reduceat(allc, starts)
    return KmerTable(allk[starts], sums.astype(np.int64))


def count_files_merged(paths, k: int, min_count: int = 1) -> KmerTable:
    """Count several files (chunks of one sample) and merge, reference-style."""
    tables = []
    codec = None
    for p in paths:
        from mercat2_tpu.io.fasta import parse_fasta_seq

        seq, rec = parse_fasta_seq(p)
        codec = codec_for_bytes(seq, prefer=codec)
        tables.append(KmerCounter(k, codec).count(seq, rec, min_count))
    return merge_tables(tables, k)
