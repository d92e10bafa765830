"""FASTQ handling: QC stats, read filtering/trimming, fasta conversion.

The reference shells out to external tools for this stage — fastqc for QC
(/root/reference/lib/mercat2_fasta.py:150), fastp for trimming (:169) and
``sed`` for fastq->fasta (:192-197). None touch the device (host-side
preprocessing), so this module provides native equivalents:

- :func:`qc` computes per-position quality percentiles, per-read GC and
  length distributions and writes a standalone HTML report,
- :func:`trim` applies fastp's *default* SE pipeline: adapter trimming
  (fastp's trimBySequence matching rule — min 4-base overlap with one
  mismatch allowed per 8 compared bases) followed by fastp's default read
  filters (quality-limit 15 / unqualified-percent 40, N-limit 5, min
  length 15). Adapter auto-detection implements fastp's seed-consensus
  evaluator (count 10-base seeds, extend the enriched winner by majority
  vote — see :func:`_evaluate_adapter_consensus`), snapping consensus
  hits onto the known Illumina adapters and keeping a known-adapter
  prefix probe as a low-frequency fallback (pass ``adapter=`` to pin a
  sequence, ``adapter=None`` to disable). Behavior is pinned to fastp's
  documented SE defaults in tests/test_fastq_orf.py (note: the reference's
  golden test-qc tree was produced WITHOUT fastp installed — its 0.05 s
  load proves trimming was skipped — so clean/Test_R1.fna.gz there is the
  raw conversion; with fastp present the reference would drop the same
  8-N read we drop),
- :func:`fq2fa` converts records 1:1 to a gzipped FASTA, exactly like the
  reference's ``sed -n '1~4s/^@/>/p;2~4p'`` pipeline.

Parsing is vectorized numpy over the raw byte buffer (no per-read loop).
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path

import numpy as np

from mercat2_tpu.io.fasta import read_file_bytes

__all__ = ["FastqArrays", "read_fastq", "qc", "trim", "fq2fa"]

_NL = 10


class FastqArrays:
    """Column-oriented FASTQ: flat byte arrays + per-read offsets."""

    def __init__(self, headers, seq, qual, offsets):
        self.headers = headers  # list[bytes] (without '@')
        self.seq = seq  # uint8[total_bases]
        self.qual = qual  # uint8[total_bases] (phred+33 raw bytes)
        self.offsets = offsets  # int64[n_reads+1] into seq/qual

    @property
    def n_reads(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def read_seq(self, i: int) -> bytes:
        return self.seq[self.offsets[i] : self.offsets[i + 1]].tobytes()

    def read_qual(self, i: int) -> bytes:
        return self.qual[self.offsets[i] : self.offsets[i + 1]].tobytes()


def read_fastq(path) -> FastqArrays:
    data = read_file_bytes(path)
    if data and not data.endswith(b"\n"):
        data += b"\n"
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        return FastqArrays([], np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                           np.zeros(1, np.int64))
    nl = np.flatnonzero(arr == _NL)
    starts = np.concatenate([[0], nl[:-1] + 1])
    ends = nl  # line i occupies [starts[i], ends[i])
    n_lines = len(nl)
    n_reads = n_lines // 4
    if n_lines % 4:
        raise ValueError(f"truncated FASTQ: {n_lines} lines")

    headers = []
    seq_parts = []
    qual_parts = []
    lens = np.empty(n_reads, dtype=np.int64)
    for r in range(n_reads):
        h0, h1 = starts[4 * r], ends[4 * r]
        headers.append(arr[h0 + 1 : h1].tobytes())
        s0, s1 = starts[4 * r + 1], ends[4 * r + 1]
        q0, q1 = starts[4 * r + 3], ends[4 * r + 3]
        if s1 - s0 != q1 - q0:
            raise ValueError(f"read {r}: seq/qual length mismatch")
        seq_parts.append(arr[s0:s1])
        qual_parts.append(arr[q0:q1])
        lens[r] = s1 - s0
    offsets = np.concatenate([[0], np.cumsum(lens)])
    seq = np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8)
    qual = np.concatenate(qual_parts) if qual_parts else np.zeros(0, np.uint8)
    return FastqArrays(headers, seq, qual, offsets)


def _qc_stats(fq: FastqArrays) -> dict:
    lens = fq.lengths()
    q = fq.qual.astype(np.int32) - 33
    n = fq.n_reads
    max_len = int(lens.max()) if n else 0
    # per-position quality percentiles via a (reads x max_len) masked matrix
    stats_pos = []
    if n:
        pos_of = np.concatenate([np.arange(l) for l in lens])
        read_of = np.repeat(np.arange(n), lens)
        mat = np.full((n, max_len), -1, dtype=np.int32)
        mat[read_of, pos_of] = q
        for p in range(max_len):
            col = mat[:, p]
            col = col[col >= 0]
            if col.size == 0:
                continue
            stats_pos.append(
                dict(
                    pos=p + 1,
                    mean=float(col.mean()),
                    q25=float(np.percentile(col, 25)),
                    median=float(np.percentile(col, 50)),
                    q75=float(np.percentile(col, 75)),
                )
            )
    gc = np.zeros(n)
    if n:
        is_gc = (fq.seq == ord("G")) | (fq.seq == ord("C"))
        gc_per_read = np.add.reduceat(is_gc.astype(np.int64), fq.offsets[:-1])
        gc = np.where(lens > 0, 100.0 * gc_per_read / np.maximum(lens, 1), 0.0)
    mean_q_per_read = (
        np.add.reduceat(q.astype(np.int64), fq.offsets[:-1]) / np.maximum(lens, 1)
        if n
        else np.zeros(0)
    )

    # fastqc-style per-base sequence content: % A/C/G/T/N at each position
    content = []
    if n:
        bmat = np.zeros((n, max_len), np.uint8)
        bmat[read_of, pos_of] = fq.seq
        covered = np.maximum((bmat > 0).sum(axis=0), 1)
        pct = {
            b: (bmat == ord(b)).sum(axis=0) * 100.0 / covered
            for b in "ACGTN"
        }
        content = [
            {"pos": p + 1, **{b.lower(): round(float(pct[b][p]), 2)
                              for b in "ACGTN"}}
            for p in range(max_len)
        ]

    return dict(
        n_reads=n,
        total_bases=int(lens.sum()) if n else 0,
        min_len=int(lens.min()) if n else 0,
        max_len=max_len,
        mean_len=float(lens.mean()) if n else 0.0,
        mean_gc=float(gc.mean()) if n else 0.0,
        per_position=stats_pos,
        per_base_content=content,
        mean_read_quality=float(mean_q_per_read.mean()) if n else 0.0,
        duplication=_duplication_stats(fq),
        overrepresented=_overrepresented(fq),
    )


#: fastqc tracks the first 100k distinct sequences, truncated to 50 bp
_DUP_SAMPLE = 100_000
_DUP_TRUNC = 50
_DUP_BINS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 50, 100, 500, 1000, 5000, 10000]
_DUP_LABELS = ["1", "2", "3", "4", "5", "6", "7", "8", "9", ">10", ">50",
               ">100", ">500", ">1k", ">5k", ">10k"]


def _sampled_keys(fq: FastqArrays) -> np.ndarray:
    """S50 byte-string keys (reads truncated to 50 bp) of the sample."""
    n = min(fq.n_reads, _DUP_SAMPLE)
    if n == 0:
        return np.zeros(0, dtype=f"S{_DUP_TRUNC}")
    keylen = np.minimum(fq.lengths()[:n], _DUP_TRUNC)
    mat = np.zeros((n, _DUP_TRUNC), np.uint8)
    pos = np.arange(_DUP_TRUNC)[None, :]
    take = pos < keylen[:, None]
    mat[take] = fq.seq[
        (fq.offsets[:n, None] + pos)[take]
    ]
    return mat.view(f"S{_DUP_TRUNC}").ravel()


def _duplication_stats(fq: FastqArrays) -> dict:
    """fastqc-style sequence duplication levels.

    Reads (truncated to 50 bp like fastqc) are exact-matched; the
    histogram bins duplication levels 1..9, >10, >50, ... and reports the
    percentage of all reads and of distinct reads per bin, plus the
    fraction of the library remaining after deduplication (fastqc's
    headline number)."""
    keys = _sampled_keys(fq)
    if keys.size == 0:
        return dict(pct_remaining_if_dedup=100.0, levels=[])
    _, counts = np.unique(keys, return_counts=True)
    total = int(counts.sum())
    distinct = int(counts.size)
    idx = np.digitize(counts, _DUP_BINS[1:], right=False)
    levels = []
    for i, label in enumerate(_DUP_LABELS):
        sel = counts[idx == i]
        if sel.size == 0 and i >= 10:
            continue
        levels.append(dict(
            level=label,
            pct_of_total=round(float(sel.sum()) * 100.0 / total, 3),
            pct_of_distinct=round(sel.size * 100.0 / distinct, 3),
        ))
    return dict(
        pct_remaining_if_dedup=round(distinct * 100.0 / total, 2),
        levels=levels,
    )


def _overrepresented(fq: FastqArrays, min_frac: float = 0.001) -> list[dict]:
    """fastqc-style overrepresented sequences: truncated reads making up
    more than ``min_frac`` of the sample, with a possible-source label
    (matched against the known adapter list, like fastqc's contaminant
    screen)."""
    keys = _sampled_keys(fq)
    if keys.size == 0:
        return []
    uniq, counts = np.unique(keys, return_counts=True)
    total = int(counts.sum())
    cut = max(2, int(min_frac * total))
    out = []
    for i in np.argsort(counts)[::-1]:
        if counts[i] < cut or len(out) >= 20:
            break
        seq = uniq[i].rstrip(b"\x00")
        source = "No Hit"
        for ad in _KNOWN_ADAPTERS:
            if ad[:12] in seq or seq[:12] in ad:
                source = f"Adapter ({ad[:16].decode()}...)"
                break
        out.append(dict(
            sequence=seq.decode("latin-1"),
            count=int(counts[i]),
            percentage=round(float(counts[i]) * 100.0 / total, 3),
            possible_source=source,
        ))
    return out


def qc(fq_file, outpath, f_name: str) -> Path:
    """Write a QC report (HTML + JSON) for one FASTQ file."""
    outpath = Path(outpath)
    outpath.mkdir(parents=True, exist_ok=True)
    fq = read_fastq(fq_file)
    stats = _qc_stats(fq)
    stem = Path(str(fq_file)).name
    json_out = outpath / f"{stem}_qc.json"
    json_out.write_text(json.dumps(stats, indent=1))

    # lightweight standalone HTML (plotly-free; inline SVG of quality curve)
    from mercat2_tpu.report.figures import quality_curve_svg

    html_out = outpath / f"{stem}_qc.html"
    scalar = {
        k: v for k, v in stats.items()
        if k not in ("per_position", "per_base_content", "duplication",
                     "overrepresented")
    }
    rows = "".join(
        f"<tr><td>{k}</td><td>{v}</td></tr>" for k, v in scalar.items()
    )
    dup = stats["duplication"]
    dup_rows = "".join(
        f"<tr><td>{d['level']}</td><td>{d['pct_of_total']}</td>"
        f"<td>{d['pct_of_distinct']}</td></tr>"
        for d in dup.get("levels", [])
    )
    over_rows = "".join(
        f"<tr><td><code>{o['sequence']}</code></td><td>{o['count']}</td>"
        f"<td>{o['percentage']}</td><td>{o['possible_source']}</td></tr>"
        for o in stats["overrepresented"]
    ) or "<tr><td colspan='4'>none over 0.1%</td></tr>"
    html_out.write_text(
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>QC {stem}</title></head><body><h1>Read QC: {stem}</h1>"
        f"<table border='1'>{rows}</table>"
        f"{quality_curve_svg(stats['per_position'])}"
        "<h2>Sequence duplication levels</h2>"
        f"<p>Reads remaining if deduplicated: "
        f"{dup['pct_remaining_if_dedup']}%</p>"
        "<table border='1'><tr><th>level</th><th>% of total</th>"
        f"<th>% of distinct</th></tr>{dup_rows}</table>"
        "<h2>Overrepresented sequences</h2>"
        "<table border='1'><tr><th>sequence (50bp)</th><th>count</th>"
        f"<th>%</th><th>possible source</th></tr>{over_rows}</table>"
        "</body></html>"
    )
    return html_out


#: standard Illumina adapters probed by the auto-detector (fastp ships the
#: same known-adapter fallback list)
_KNOWN_ADAPTERS = (
    b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",  # TruSeq / universal read-1
    b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT",  # TruSeq read-2
    b"CTGTCTCTTATACACATCT",                # Nextera
)


def _adapter_trim_pos(seq: bytes, adapter: bytes) -> int:
    """First position where the adapter matches (fastp trimBySequence rule:
    compare the adapter prefix against the read suffix starting at each
    position; overlap >= 4 bases, <= 1 mismatch per 8 compared bases).
    Returns len(seq) when no match."""
    rlen, alen = len(seq), len(adapter)
    for pos in range(rlen - 4 + 1):
        cmplen = min(rlen - pos, alen)
        allowed = cmplen // 8
        mism = 0
        for i in range(cmplen):
            if seq[pos + i] != adapter[i]:
                mism += 1
                if mism > allowed:
                    break
        else:
            return pos
    return rlen


def _adapter_trim_pos_batch(fq: FastqArrays, adapter: bytes) -> np.ndarray:
    """int64[n_reads] trim cut per read — vectorized trimBySequence.

    Bit-identical to :func:`_adapter_trim_pos` applied per read (tested),
    but runs as ``len(adapter)`` vector passes over the flat base array
    instead of a per-read Python loop (the loop was O(bases * alen) in the
    interpreter — minutes on real FASTQ files).
    """
    n = fq.n_reads
    if n == 0:
        return np.zeros(0, np.int64)
    total = int(fq.offsets[-1])
    if total == 0:  # all reads empty: scalar rule returns rlen == 0
        return np.zeros(n, np.int64)
    alen = len(adapter)
    a = np.frombuffer(adapter, np.uint8)
    read_of = np.repeat(np.arange(n, dtype=np.int64), fq.lengths())
    end_of = fq.offsets[1:][read_of]          # read end per global position
    avail = end_of - np.arange(total)         # rlen - pos
    cmplen = np.minimum(avail, alen)

    seq_pad = np.concatenate([fq.seq, np.zeros(alen, np.uint8)])
    mism = np.zeros(total, np.int32)
    idx = np.arange(total)
    for i in range(alen):
        in_cmp = i < cmplen
        mism += (in_cmp & (seq_pad[idx + i] != a[i])).astype(np.int32)
    accept = (avail >= 4) & (mism <= cmplen // 8)

    big = np.int64(1 << 62)
    score = np.where(accept, idx, big)
    # clamp: a trailing empty read puts offsets[-2] == total, out of range
    # for reduceat; the lens > 0 mask below discards the garbage value.
    first = np.minimum.reduceat(score, np.minimum(fq.offsets[:-1], total - 1))
    lens = fq.lengths()
    first = np.where(lens > 0, first, big)    # reduceat quirk on empty reads
    return np.minimum(first - fq.offsets[:-1], lens)


_SEED_LEN = 10
_CODE_LUT = np.full(256, 4, np.int64)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i


def _decode_seed(sv: int) -> bytes:
    return bytes(
        b"ACGT"[(sv >> (2 * (_SEED_LEN - 1 - t))) & 3]
        for t in range(_SEED_LEN)
    )


def _evaluate_adapter_consensus(fq: FastqArrays,
                                sample: int = 100_000) -> bytes | None:
    """fastp-style seed-count + consensus-extension adapter evaluator.

    Re-derived from fastp's documented SE auto-detection behavior
    (evaluator.cpp, evalAdapterAndReadNum): count every 10-base ACGT seed
    over the sampled reads, discard low-complexity seeds (one base >= 60%
    of the seed), take the most frequent seed when its occurrence count
    clears the enrichment threshold, then extend it rightward by majority
    vote of the next base (support >= 50% of the reads carrying the
    current consensus) up to 35 bases. Vectorized numpy over the flat
    base array; tests/test_adapter_eval.py pins it against a direct
    per-read oracle of the same rules.
    """
    n = min(fq.n_reads, sample)
    if n == 0:
        return None
    end = int(fq.offsets[n])
    seq = fq.seq[:end]
    if seq.shape[0] < _SEED_LEN:
        return None
    read_of = np.repeat(np.arange(n, dtype=np.int64),
                        np.diff(fq.offsets[: n + 1]))
    code = _CODE_LUT[seq]
    m = seq.shape[0] - _SEED_LEN + 1
    packed = np.zeros(m, np.int64)
    ok = read_of[:m] == read_of[_SEED_LEN - 1 :]  # window within one read
    for t in range(_SEED_LEN):
        c = code[t : t + m]
        ok &= c < 4
        packed = (packed << 2) | c
    seeds = packed[ok]
    if seeds.size == 0:
        return None
    counts = np.bincount(seeds, minlength=4 ** _SEED_LEN)
    thresh = max(10, n // 20)
    for sv in np.argsort(counts)[::-1][:256]:
        c = int(counts[sv])
        if c < thresh:
            return None
        kmer = _decode_seed(int(sv))
        if max(kmer.count(b) for b in b"ACGT") >= 0.6 * _SEED_LEN:
            continue  # low complexity
        return _extend_consensus(seq, read_of, kmer)
    return None


def _extend_consensus(seq: np.ndarray, read_of: np.ndarray,
                      seed: bytes) -> bytes:
    """Extend a winning seed rightward by per-read majority vote."""
    adapter = bytearray(seed)
    while len(adapter) < 35:
        a = np.frombuffer(bytes(adapter), np.uint8)
        la = a.shape[0]
        m = seq.shape[0] - la  # a hit needs la bases + the next one
        if m <= 0:
            break
        match = np.ones(m, bool)
        for t in range(la):
            match &= seq[t : t + m] == a[t]
        match &= read_of[:m] == read_of[la : la + m]
        hits = np.flatnonzero(match)
        if hits.size == 0:
            break
        # first occurrence per read, like fastp's find-based walk
        first = hits[np.unique(read_of[hits], return_index=True)[1]]
        nxt = np.bincount(seq[first + la], minlength=256)
        b = int(nxt.argmax())
        if int(nxt[b]) < max(2, first.size // 2):
            break
        adapter.append(b)
    return bytes(adapter)


def _snap_known(consensus: bytes) -> bytes | None:
    """Map a detected consensus onto a known Illumina adapter (fastp also
    reports matches against its known-adapter list)."""
    for known in _KNOWN_ADAPTERS:
        if (
            known.startswith(consensus)
            or consensus[:12] in known
            or known[:12] in consensus
        ):
            return known
    return None


def _probe_known_adapters(fq: FastqArrays,
                          min_hit_frac: float = 0.01) -> bytes | None:
    """Probe the known Illumina adapter prefixes against the reads.

    Fallback sensitivity pass when the consensus evaluator finds nothing
    (adapter present in < ~5% of reads): an adapter is reported when >=
    ``min_hit_frac`` of reads contain its 12-base prefix."""
    n = fq.n_reads
    if n == 0:
        return None
    sample = min(n, 100_000)
    sample_end = int(fq.offsets[sample])
    seq = fq.seq[:sample_end]
    read_of = np.repeat(np.arange(sample, dtype=np.int64),
                        np.diff(fq.offsets[: sample + 1]))
    for adapter in _KNOWN_ADAPTERS:
        probe = np.frombuffer(adapter[:12], np.uint8)
        m = len(probe)
        if seq.shape[0] < m:
            continue
        match = np.ones(seq.shape[0] - m + 1, bool)
        for t in range(m):
            match &= seq[t : seq.shape[0] - m + 1 + t] == probe[t]
        starts = np.flatnonzero(match)
        # a hit must lie entirely within one read
        starts = starts[
            starts + m <= fq.offsets[read_of[starts] + 1]
        ]
        hits = np.unique(read_of[starts]).size
        if hits >= max(1, int(min_hit_frac * sample)):
            return adapter
    return None


def _detect_adapter(fq: FastqArrays, min_hit_frac: float = 0.01) -> bytes | None:
    """Auto-detect the adapter, fastp style.

    The seed-consensus evaluator (fastp's algorithm) runs first; a
    consensus overlapping a known Illumina adapter snaps to the full known
    sequence (fastp reports known-adapter matches the same way), and an
    unknown consensus is used as-is — custom adapters are detected too.
    When the evaluator finds nothing, the known-adapter prefix probe adds
    a sensitivity fallback for low-frequency contamination."""
    consensus = _evaluate_adapter_consensus(fq)
    if consensus is not None:
        return _snap_known(consensus) or consensus
    return _probe_known_adapters(fq, min_hit_frac)


def trim(
    fq_file,
    outpath,
    f_name: str,
    qualified_quality_phred: int = 15,
    unqualified_percent_limit: float = 40.0,
    n_base_limit: int = 5,
    length_required: int = 15,
    adapter: bytes | str | None = "auto",
) -> Path:
    """fastp-default SE trim: adapter trimming + read filters; writes
    ``{name}_trim.fastq`` (reference invocation: ``fastp -i in -o out``,
    /root/reference/lib/mercat2_fasta.py:169)."""
    outpath = Path(outpath)
    outpath.mkdir(parents=True, exist_ok=True)
    out_file = outpath / f"{f_name}_trim.fastq"

    fq = read_fastq(fq_file)

    if adapter == "auto":
        adapter = _detect_adapter(fq)
    elif isinstance(adapter, str):
        adapter = adapter.encode()
    if adapter and fq.n_reads:
        # per-read adapter clip BEFORE the filters, like fastp (vectorized)
        cut = _adapter_trim_pos_batch(fq, adapter)
        read_of = np.repeat(np.arange(fq.n_reads, dtype=np.int64),
                            fq.lengths())
        pos_in_read = np.arange(int(fq.offsets[-1])) - fq.offsets[read_of]
        keep_base = pos_in_read < cut[read_of]
        fq = FastqArrays(
            fq.headers,
            fq.seq[keep_base],
            fq.qual[keep_base],
            np.concatenate([[0], np.cumsum(cut)]).astype(np.int64),
        )

    lens = fq.lengths()
    q = fq.qual.astype(np.int32) - 33
    if fq.n_reads:
        bad = (q < qualified_quality_phred).astype(np.int64)
        bad_per_read = np.add.reduceat(bad, fq.offsets[:-1])
        n_per_read = np.add.reduceat(
            (fq.seq == ord("N")).astype(np.int64), fq.offsets[:-1]
        )
        keep = (
            (bad_per_read <= (unqualified_percent_limit / 100.0) * np.maximum(lens, 1))
            & (n_per_read <= n_base_limit)
            & (lens >= length_required)
        )
    else:
        keep = np.zeros(0, dtype=bool)

    kept = dropped = 0
    with open(out_file, "wb") as w:
        for i in np.flatnonzero(keep):
            w.write(b"@" + fq.headers[i] + b"\n")
            w.write(fq.read_seq(i) + b"\n+\n")
            w.write(fq.read_qual(i) + b"\n")
            kept += 1
    dropped = fq.n_reads - kept
    report = dict(
        input_reads=fq.n_reads,
        kept_reads=kept,
        dropped_reads=int(dropped),
        adapter=adapter.decode() if adapter else None,
        adapter_detector=(
            "fastp-style seed-consensus evaluator (snapped to known "
            "Illumina adapters) with a known-adapter prefix-probe "
            "fallback; pinned against a per-read oracle in "
            "tests/test_adapter_eval.py"
        ),
        filters=dict(
            qualified_quality_phred=qualified_quality_phred,
            unqualified_percent_limit=unqualified_percent_limit,
            n_base_limit=n_base_limit,
            length_required=length_required,
        ),
    )
    (outpath / f"{f_name}-trim.json").write_text(json.dumps(report, indent=1))
    return out_file


def fq2fa(fq_file, outpath, f_name: str) -> Path:
    """FASTQ -> gzipped FASTA, mirroring the reference's sed pipeline
    (header line with '@'->'>' + raw sequence line, one per read)."""
    outpath = Path(outpath)
    outpath.mkdir(parents=True, exist_ok=True)
    out_file = outpath / f"{f_name}.fna.gz"
    data = read_file_bytes(fq_file)
    lines = data.split(b"\n")
    with gzip.open(out_file, "wb") as w:
        for r in range(len(lines) // 4):
            header = lines[4 * r]
            # sed '1~4s/^@/>/p' prints the header only when the substitution
            # matched; '2~4p' prints the sequence line unconditionally
            if header.startswith(b"@"):
                w.write(b">" + header[1:] + b"\n")
            w.write(lines[4 * r + 1] + b"\n")
    return Path(out_file).absolute()
