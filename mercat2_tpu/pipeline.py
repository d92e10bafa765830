"""Pipeline orchestrator: the reference's ``mercat_main`` flow, rebuilt.

Stage graph (mirrors /root/reference/bin/mercat2.py:186-503):

    discover inputs (by extension)            bin/mercat2.py:253-283
      fastq  -> qc + trim + fq2fa             lib/mercat2_fasta.py:135-198
      fna    -> clean (removeN) + stats       lib/mercat2_fasta.py:53, bin:277-281
      faa    -> registered directly
    chunk large files                          bin/mercat2.py:312-328
    count per sample (device engine)           bin/mercat2.py:115-137
    combined TSV + figures + PCA               bin/mercat2.py:141-181
    alpha/beta diversity                       lib/mercat2_diversity.py
    ORF calling -> protein rounds              bin/mercat2.py:368-407
    HTML report + protein metrics              bin/mercat2.py:465-471

The parallel runtime differs by design: the reference schedules every task
on a local Ray cluster; here host-side prep (parse/clean/convert) runs in a
thread pool while device work is dispatched asynchronously through JAX (one
in-flight count per device stream keeps the device busy while the host
prepares the next file). No Ray, no object store — arrays flow in memory.
"""

from __future__ import annotations

import dataclasses
import gzip
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from mercat2_tpu.engine.codec import codec_for_bytes
from mercat2_tpu.engine.counter import KmerCounter, merge_tables
from mercat2_tpu.io.chunker import maybe_chunk
from mercat2_tpu.io.clean import remove_n
from mercat2_tpu.io.fasta import parse_fasta_seq
from mercat2_tpu.io import fastq as fq_mod
from mercat2_tpu.metrics.alpha import compute_alpha_diversity
from mercat2_tpu.metrics.assembly import write_assembly_stats
from mercat2_tpu.metrics.beta import compute_beta_diversity
from mercat2_tpu.report import figures as figs
from mercat2_tpu.report.html import write_html
from mercat2_tpu.report.tsv import merge_tsv, merge_tsv_T, write_counts_tsv

__all__ = ["PipelineConfig", "run_pipeline", "FILE_EXT_FASTQ", "FILE_EXT_NUCLEOTIDE", "FILE_EXT_PROTEIN"]

FILE_EXT_FASTQ = [".fq", ".fastq", ".fq.gz", ".fastq.gz"]
FILE_EXT_NUCLEOTIDE = [
    ".fasta", ".fa", ".fna", ".ffn",
    ".fasta.gz", ".fa.gz", ".fna.gz", ".ffn.gz",
]
FILE_EXT_PROTEIN = [".faa", ".faa.gz"]


@dataclasses.dataclass
class PipelineConfig:
    kmer: int
    input_files: list = dataclasses.field(default_factory=list)
    input_folder: str | None = None
    min_count: int = 10
    num_cores: int = 0  # 0 = auto
    chunk_size_mb: int = 100
    output: str = "mercat_results"
    replace: bool = False
    lowmem: bool | None = None
    skipclean: bool = False
    toupper: bool = False
    pca: bool = False
    prodigal: bool = False  # -prod: ORF call (pyrodigal if present, else native)
    fgs: bool = False  # -fgs: second ORF annotation round (native finder)
    category_file: str | None = None
    debug: bool = False
    #: compute protein metrics and alpha diversity on the accelerator
    #: (float32, mercat2_tpu.metrics.device); the host float64 path is the
    #: bit-parity default
    device_metrics: bool = False
    #: device-mesh policy for the count engine: "auto" shards counting over
    #: all local devices when more than one is visible (single chip: the
    #: async single-device engine), "off" forces single-device, an integer
    #: string uses exactly that many devices. The device-side replacement
    #: for the reference's Ray worker count (-n), which governed CPU task
    #: parallelism (/root/reference/bin/mercat2.py:217).
    mesh: str = "auto"


def _file_ext(path: Path) -> str:
    suffixes = path.suffixes
    for i in range(len(suffixes)):
        ext = "".join(suffixes[i:])
        if ext in FILE_EXT_FASTQ + FILE_EXT_NUCLEOTIDE + FILE_EXT_PROTEIN:
            return ext
    return ""


def _discover_inputs(cfg: PipelineConfig) -> list[Path]:
    files = [Path(f) for f in cfg.input_files]
    if cfg.input_folder:
        folder = Path(cfg.input_folder).expanduser().absolute()
        for fname in sorted(p.name for p in folder.iterdir()):
            p = folder / fname
            if p.is_file() and _file_ext(p):
                files.append(p)
    return files


#: total decompressed bytes of parse handles kept open between the codec
#: pre-pass and stream building (beyond this, files are re-parsed lazily)
_HOLD_CAP = 1 << 30


def _group_plan(group: dict, k: int, workers: int | None = None):
    """Metadata pre-pass over a sample group: one shared codec.

    Parses every file (in threads) to union the alphabet — chunks of a
    sample must share a codec so their numeric keys merge, and one codec
    per group keeps a single compiled program shape family. Parse handles
    are kept open (up to ``_HOLD_CAP`` decompressed bytes) and returned so
    stream building does not decompress the same file twice.

    Returns (codec, handles) where handles maps path -> NativeFasta.
    """
    import numpy as np

    from mercat2_tpu.engine.codec import (
        alphabet_of, canonical_codec, codec_for_alphabet,
    )
    from mercat2_tpu.io.native import open_fasta_native

    paths = [f for files in group.values() for f in files]

    def scan(f):
        try:
            nf = open_fasta_native(f)
        except OSError:
            nf = None
        if nf is not None:
            return f, nf, nf.alphabet()
        seq, _rec = parse_fasta_seq(f)
        return f, None, alphabet_of(seq)

    alpha = np.zeros(0, np.uint8)
    handles: dict = {}
    held = 0
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for f, nf, present in pool.map(scan, paths):
            alpha = np.union1d(alpha, present)
            if nf is not None:
                if held + nf.seq_len <= _HOLD_CAP:
                    handles[f] = nf
                    held += nf.seq_len
                else:
                    nf.close()
    if alpha.size == 0:
        for nf in handles.values():
            nf.close()
        return None, {}
    alpha = alpha.astype(np.uint8)
    # canonical codecs (2-bit DNA / 5-bit protein) keep the whole pipeline
    # on two compiled program families — see engine.codec.canonical_codec
    codec = canonical_codec(alpha)
    return (codec if codec is not None else codec_for_alphabet(alpha)), handles


def _build_stream(path, counter: KmerCounter, bucket: int | None, nf=None):
    """Host-side stream build for one file (native parse when available).

    ``nf`` is an already-open NativeFasta from the group plan; it is
    closed here after use."""
    from mercat2_tpu.io.native import open_fasta_native

    if nf is None:
        try:
            nf = open_fasta_native(path)
        except OSError:
            pass
    if nf is not None:
        with nf:
            return counter.build_stream_native(nf, bucket)
    seq, rec = parse_fasta_seq(path)
    from mercat2_tpu.engine.counter import _drop_short_records

    seq, rec = _drop_short_records(seq, rec, counter.k)
    if seq.shape[0] < counter.k:
        return None
    return counter.build_stream(seq, rec, bucket)


#: in-flight speculative compiles of the uniform count program, keyed by
#: (k, codec.bits, codec.size). See _start_prewarm.
_PREWARMS: dict[tuple, threading.Thread] = {}


def _prewarm_uniform(k: int, codec, min_count: int,
                     family: int | None, gap_family: int | None) -> None:
    import numpy as np

    from mercat2_tpu.engine.counter import KmerCounter, NumpySource

    try:
        counter = KmerCounter(k, codec)
        seq = np.tile(codec.symbols[: min(4, codec.size)], max(k, 8))
        src = NumpySource(seq, np.zeros(seq.shape[0], np.int64), codec)
        pendings = counter.dispatch_packed_uniform(
            [src], min_count, family=family, gap_family=gap_family
        )
        for p in pendings or []:
            p.table()
    except Exception:  # pragma: no cover - speculative; real path reports
        pass


def _start_prewarm(k: int, codec, min_count: int,
                   syms_hint: int = 0, gaps_hint: int = 0) -> None:
    """Compile the uniform count program for (k, codec) in the background.

    The pipeline kicks the two known program families off as soon as the
    input mix is known, overlapping their compiles with host-side load /
    clean / ORF stages (whether this still pays with a persistent compile
    cache is not measured on the H100). The
    count stage joins the matching thread before dispatching. ``syms_hint``
    (estimated max symbols per file) and ``gaps_hint`` (estimated max
    records per file) pick the size and gap-slot families to compile.
    """
    key = (k, codec.bits, codec.size)
    if key in _PREWARMS:
        return
    from mercat2_tpu.engine.counter import KmerCounter

    counter = KmerCounter(k, codec)
    family = counter._uniform_family([max(0, syms_hint)])
    gap_family = counter._uniform_gap_family([max(0, gaps_hint)])
    t = threading.Thread(
        target=_prewarm_uniform,
        args=(k, codec, min_count, family, gap_family),
        daemon=True,
    )
    _PREWARMS[key] = t
    t.start()


def _join_prewarm(k: int, codec) -> None:
    t = _PREWARMS.get((k, codec.bits, codec.size))
    if t is not None:
        t.join()


def _print_devices() -> None:
    """One line naming the accelerator the count engine runs on, so a
    backend that silently fell back to the CPU shows in every run log."""
    import jax

    devices = jax.devices()
    print(f"Devices: platform={devices[0].platform} "
          f"device_kind={devices[0].device_kind} count={len(devices)}")


def _resolve_mesh(policy: str):
    """PipelineConfig.mesh -> a flat device mesh or None (single-device)."""
    if policy == "off":
        return None
    import jax

    # multi-host: each process meshes over its OWN devices only — hosts
    # own disjoint files (host_shard), so counting never crosses hosts
    # and global (non-addressable) devices must stay out of the mesh.
    devices = (
        jax.local_devices() if jax.process_count() > 1 else jax.devices()
    )
    n = len(devices)
    want = n if policy == "auto" else min(int(policy), n)
    if want <= 1:
        return None
    from mercat2_tpu.parallel import flat_mesh

    return flat_mesh(want, devices=devices)


def _count_group_mesh(group: dict, counter: KmerCounter, min_count: int,
                      out_tsv_dir: Path, bucket, workers, handles,
                      mesh) -> dict:
    """Mesh-sharded counting for one sample group (multi-device runs).

    Streams build in host threads; each batch of files is counted in ONE
    sharded device program (splitter-partitioned distributed sort, see
    mercat2_tpu.parallel.count) that returns exact per-file filtered
    tables. Device-side work scales O(N/D) per device — the replacement
    for the reference's Ray fan-out across CPU workers
    (/root/reference/bin/mercat2.py:115-137).
    """
    from mercat2_tpu.engine.counter import _REC_GAP
    from mercat2_tpu.parallel import (
        sharded_count_sources, sharded_count_streams,
    )

    jobs = [(basename, f) for basename, files in group.items() for f in files]
    tables: dict[str, list] = {basename: [] for basename in group}
    tsv_list: dict[str, Path] = {}
    target_syms = 256 << 20
    packed = counter.packable()

    with ThreadPoolExecutor(max_workers=workers) as pool:
        if packed:
            # bit-packed transport (same PackedGroup as the single-chip
            # path): h2d ships `bits` per symbol instead of 8
            futs = [
                (basename, pool.submit(
                    counter.source_for, f, (handles or {}).pop(f, None)
                ))
                for basename, f in jobs
            ]
        else:
            futs = [
                (basename, pool.submit(
                    _build_stream, f, counter, None,
                    (handles or {}).pop(f, None),
                ))
                for basename, f in jobs
            ]
        batch_names: list[str] = []
        batch_items: list = []
        batch_syms = 0

        def flush() -> None:
            nonlocal batch_names, batch_items, batch_syms
            if not batch_items:
                return
            if packed:
                batch_tables = sharded_count_sources(
                    counter, batch_items, min_count, mesh
                )
                for s in batch_items:
                    s.close()
            else:
                batch_tables = sharded_count_streams(
                    counter, batch_items, min_count, mesh
                )
            for name, tbl in zip(batch_names, batch_tables):
                tables[name].append(tbl)
            batch_names, batch_items, batch_syms = [], [], 0

        for basename, fut in futs:
            item = fut.result()
            if item is None:
                continue
            batch_names.append(basename)
            batch_items.append(item)
            batch_syms += (
                item.packed_len(_REC_GAP) if packed else item.shape[0]
            )
            if len(batch_items) >= 32 or batch_syms > target_syms:
                flush()
        flush()

    for basename in group:
        merged = merge_tables(tables[basename], counter.k)
        if len(merged):
            print(f"Significant k-mers: {len(merged)}")
            tsv_list[basename] = write_counts_tsv(
                merged, basename, out_tsv_dir / f"{basename}_counts.tsv"
            )
        else:
            print("No significant k-mers found")
    return tsv_list


def _count_group(group: dict, counter: KmerCounter, min_count: int,
                 out_tsv_dir: Path, bucket: int | None,
                 workers: int | None, handles: dict | None = None,
                 mesh=None) -> dict:
    """Count every sample of a group through a host/device pipeline.

    Three overlapping stages (the device-side analogue of the reference's
    Ray task graph, /root/reference/bin/mercat2.py:115-137):
      1. threads: parse + encode + pad each file into a code stream
         (the native C++ fill releases the GIL);
      2. device: counts dispatched asynchronously in submission order;
      3. host: fetch + decode + TSV write, trailing the device queue.

    The min-count filter stays per file before the merge, matching the
    reference's per-chunk semantics (/root/reference/lib/mercat2_kmers.py:73-76).
    """
    from collections import deque

    from mercat2_tpu.engine.counter import _MAX_DEVICE_K, _REC_GAP

    jobs = [(basename, f) for basename, files in group.items() for f in files]
    if mesh is not None and counter.k <= _MAX_DEVICE_K:
        return _count_group_mesh(
            group, counter, min_count, out_tsv_dir, bucket, workers,
            handles, mesh,
        )
    if counter.k > _MAX_DEVICE_K:  # exact host fallback for pathological k
        tsv_list = {}
        for basename, files in group.items():
            merged = merge_tables(
                [counter.count(*parse_fasta_seq(f), min_count) for f in files],
                counter.k,
            )
            if len(merged):
                tsv_list[basename] = write_counts_tsv(
                    merged, basename, out_tsv_dir / f"{basename}_counts.tsv"
                )
        return tsv_list
    from mercat2_tpu.engine.counter import fetch_tables

    window = max(8, 2 * (workers or 4))
    tables: dict[str, list] = {basename: [] for basename in group}
    tsv_list: dict[str, Path] = {}

    if counter.packable() and min_count > 1:
        # Uniform fixed-shape launches: the whole round shares ONE compiled
        # device program per (k, codec) family, so compile time stays
        # bounded however many files a round has. The adaptive-shape
        # dispatchers below remain for min_count == 1 (unbounded tables)
        # and non-packable codecs. Sources are built, dispatched, fetched
        # and closed in bounded waves (not all files up-front), so open
        # handles and host RSS stay O(wave), not O(round).
        _join_prewarm(counter.k, counter.codec)
        leftover: list[tuple[str, object]] = []   # (basename, file) no-fits
        inflight_waves: deque = deque()           # (names, pendings)
        wave: list[tuple] = []                    # (basename, file, source)
        wave_syms = 0
        wave_cap_syms = 2 * counter._UNIFORM_SYMS
        wave_cap_files = 2 * counter._UNIFORM_FILES

        # pin the uniform size + gap-slot families for the whole round
        # from the FIRST wave's exact bounds (rounds are homogeneous), so
        # every wave shares ONE program; dispatch upgrades per wave if a
        # later file is bigger
        round_family: int | None = None
        round_gap_family: int | None = None

        def fetch_wave() -> None:
            names, pendings = inflight_waves.popleft()
            for name, tbl in zip(names, fetch_tables(pendings)):
                tables[name].append(tbl)

        def dispatch_wave() -> bool:
            nonlocal wave, wave_syms, round_family, round_gap_family
            if not wave:
                return True
            if round_family is None:
                round_family = counter._uniform_family(
                    [s.packed_len(_REC_GAP) for _, _, s in wave]
                )
                round_gap_family = counter._uniform_gap_family(
                    [counter._gap_bound(s) for _, _, s in wave]
                )
            pendings = counter.dispatch_packed_uniform(
                [s for _, _, s in wave], min_count, workers,
                family=round_family, gap_family=round_gap_family,
            )
            if pendings is None:  # rare mixed dense/sort edge: bail to adaptive
                return False
            for _, _, s in wave:
                s.close()
            inflight_waves.append(([n for n, _, _ in wave], pendings))
            wave, wave_syms = [], 0
            while len(inflight_waves) > 2:
                fetch_wave()
            return True

        ok = True
        handles = dict(handles or {})
        src_of: dict = {}  # file -> built source, for the adaptive fallback
        with ThreadPoolExecutor(max_workers=workers) as pool:
            build_ahead = max(8, 2 * (workers or 4))
            pend_jobs = deque(jobs)
            building: deque = deque()
            while (pend_jobs or building) and ok:
                while pend_jobs and len(building) < build_ahead:
                    bname, f = pend_jobs.popleft()
                    building.append((bname, f, pool.submit(
                        counter.source_for, f, handles.pop(f, None))))
                bname, f, fut = building.popleft()
                source = fut.result()
                if not counter.fits_uniform(source):
                    leftover.append((bname, f))
                    src_of[f] = source
                    continue
                wave.append((bname, f, source))
                wave_syms += source.packed_len(_REC_GAP)
                if len(wave) >= wave_cap_files or wave_syms > wave_cap_syms:
                    ok = dispatch_wave()
            if ok:
                ok = dispatch_wave()
            if not ok:  # salvage: unfitting wave + unbuilt jobs -> adaptive
                for bname, f, s in wave:
                    leftover.append((bname, f))
                    src_of[f] = s
                for bname, f, fut in building:
                    leftover.append((bname, f))
                    src_of[f] = fut.result()
                leftover.extend(pend_jobs)
        while inflight_waves:
            fetch_wave()
        if not leftover:
            for basename in group:
                merged = merge_tables(tables[basename], counter.k)
                if len(merged):
                    print(f"Significant k-mers: {len(merged)}")
                    tsv_list[basename] = write_counts_tsv(
                        merged, basename,
                        out_tsv_dir / f"{basename}_counts.tsv"
                    )
                else:
                    print("No significant k-mers found")
            return tsv_list
        handles.update(
            {f: s for f, s in src_of.items() if hasattr(s, "fill_packed")}
        )
        jobs = leftover  # adaptive path finishes the stragglers

    def finish(batch) -> None:
        names = [name for name, _ in batch]
        for name, tbl in zip(names, fetch_tables([p for _, p in batch])):
            tables[name].append(tbl)

    packed = counter.packable()

    with ThreadPoolExecutor(max_workers=workers) as pool:
        if packed:
            futs = deque(
                (basename, pool.submit(
                    counter.source_for, f, (handles or {}).pop(f, None)
                ))
                for basename, f in jobs
            )
        else:
            futs = deque(
                (basename, pool.submit(
                    _build_stream, f, counter, bucket,
                    (handles or {}).pop(f, None),
                ))
                for basename, f in jobs
            )
        inflight: deque = deque()

        def drain() -> None:
            if len(inflight) > window:  # drain the older half, batched
                finish([inflight.popleft() for _ in range(len(inflight) // 2)])

        def flush(batch_names, batch_streams) -> None:
            for name, pending in zip(
                batch_names, counter.dispatch_streams(batch_streams, min_count)
            ):
                pending.prefetch()  # overlap the n_out roundtrip
                inflight.append((name, pending))
            drain()

        def flush_packed(batch_names, batch_sources) -> None:
            for name, pending in zip(
                batch_names,
                counter.dispatch_packed_sources(
                    batch_sources, min_count, workers=workers
                ),
            ):
                pending.prefetch()
                inflight.append((name, pending))
            for s in batch_sources:
                s.close()
            drain()

        batch_names: list[str] = []
        batch_items: list = []
        batch_syms = 0
        flush_fn = flush_packed if packed else flush
        target = counter._PACK_TARGET if packed else 512 * 2**20
        while futs:
            basename, fut = futs.popleft()
            item = fut.result()
            if item is None:
                continue
            batch_names.append(basename)
            batch_items.append(item)
            batch_syms += (
                item.packed_len(_REC_GAP) if packed else item.shape[0]
            )
            # flush a launch group once enough rows accumulate (one device
            # launch covers similar-sized rows; see dispatch_streams /
            # dispatch_packed_sources, which regroup within the batch)
            if len(batch_items) >= 32 or batch_syms > target:
                flush_fn(batch_names, batch_items)
                batch_names, batch_items, batch_syms = [], [], 0
        if batch_items:
            flush_fn(batch_names, batch_items)
        finish(list(inflight))
        inflight.clear()

    for basename in group:
        merged = merge_tables(tables[basename], counter.k)
        if len(merged):
            print(f"Significant k-mers: {len(merged)}")
            tsv_list[basename] = write_counts_tsv(
                merged, basename, out_tsv_dir / f"{basename}_counts.tsv"
            )
        else:
            print("No significant k-mers found")
    return tsv_list


def _create_figures(tsv_list: dict, type_string: str, out_path: Path,
                    cfg: PipelineConfig) -> dict:
    """combined TSVs + kmer summary + optional PCA (ref bin/mercat2.py:141-181)."""
    print(f"\nCreating {type_string} Graphs")
    fig_plots = {}
    combined = out_path / f"combined_{type_string}.tsv"
    if not combined.exists():
        merge_tsv(tsv_list, combined)
    combined_t = out_path / f"combined_{type_string}_T.tsv"
    if not combined_t.exists():
        merge_tsv_T(tsv_list, combined_t)
    fig_plots[f"Combined {type_string} kmer Summary"] = figs.kmer_summary(combined)
    if cfg.pca and len(tsv_list) > 3:
        print("\nRunning PCA")
        out_pca = out_path / f"pca_{type_string}"
        pca3d, pca2d = figs.plot_pca(combined_t, out_pca, cfg.lowmem,
                                     cfg.category_file, cfg.debug)
        if pca3d:
            fig_plots[f"{type_string} PCA 3D"] = pca3d
        if pca2d:
            fig_plots[f"{type_string} PCA 2D"] = pca2d
    return fig_plots


def run_pipeline(cfg: PipelineConfig) -> Path:
    # Multi-host: every host runs this same program; jax.distributed forms
    # the process group (the Ray-cluster replacement, SURVEY §5). Hosts own
    # disjoint input slices (host_shard below), write per-sample artifacts
    # to the shared output tree, and the coordinator alone writes combined
    # TSVs/figures/report — replacing the reference's single Ray driver
    # (/root/reference/bin/mercat2.py:217,336-339).
    from mercat2_tpu.parallel.dist import (
        barrier, host_shard, init_distributed, is_coordinator,
    )

    if cfg.pca:
        figs.require_pca_backend(cfg.lowmem, len(_discover_inputs(cfg)))
    multi = init_distributed()
    coordinator = (not multi) or is_coordinator()

    out = Path(cfg.output)
    if coordinator:
        if out.exists():
            if cfg.replace:
                shutil.rmtree(out)
            else:
                raise SystemExit(
                    f"Output folder exists, please specify another folder or use "
                    f"'-replace' to override the files. '{out}'"
                )
        out.mkdir(parents=True, exist_ok=True)
    if multi:
        barrier("outdir")

    from mercat2_tpu.utils import DebugTrace, enable_compilation_cache

    enable_compilation_cache()
    debug = DebugTrace(cfg.debug, out / "jax_trace" if cfg.debug else None)
    _print_devices()

    def _body() -> None:
        workers = cfg.num_cores or None
        cleanpath = out / "clean"
        report_dir = out / "report"
        report_dir.mkdir(parents=True, exist_ok=True)

        print(f"\nStarting MerCat2 with k-mer {cfg.kmer}\n")
        print("Loading files")
        t_start = time.perf_counter()

        samples: dict[str, dict[str, list[Path]]] = {
            "nucleotide": {}, "protein": {}, "prodigal": {}, "fgs": {}
        }
        gc_content: dict[str, float] = {}
        qc_jobs = []

        def load_fastq(path: Path, basename: str):
            fq_mod.qc(path, cleanpath, basename)
            f = path
            if not cfg.skipclean:
                f = fq_mod.trim(f, cleanpath, basename)
                fq_mod.qc(f, cleanpath, basename)
            return basename, fq_mod.fq2fa(f, cleanpath, basename)

        def load_contig(path: Path, basename: str):
            if cfg.skipclean:
                return basename, path, None
            cleaned, stat = remove_n(path, cleanpath, cfg.toupper)
            return basename, cleaned, stat

        inputs = _discover_inputs(cfg)
        if multi:
            # deterministic per-host file ownership (no task queue needed)
            inputs = host_shard(inputs)
        if cfg.min_count > 1 and _resolve_mesh(cfg.mesh) is None:
            # speculative background compiles of the two canonical uniform
            # count programs (see _start_prewarm; single-device path only).
            # Size hints pick the uniform family (small files compile a
            # ~3x cheaper program): nucleotide rounds see the input files;
            # protein rounds see faa inputs or ORF outputs (~1/3 of the
            # nt bytes). Gzipped inputs are assumed <= 4x compressed.
            from mercat2_tpu.engine.codec import DNA_CODEC, PROTEIN_CODEC

            def est_syms(p, gz_mult: float) -> int:
                # gz expansion: ~3.5-4x for DNA, ~2.2-2.6x for protein
                try:
                    sz = Path(p).stat().st_size
                except OSError:
                    return 0
                return int(sz * gz_mult) if str(p).endswith(".gz") else sz

            def est_records(p, gz_mult: float) -> int:
                """Record-count estimate: sample the first 64 KB, count
                record markers, extrapolate by (decompressed) size. Picks
                the uniform gap-slot family; a low estimate only costs one
                extra compile (dispatch upgrades per wave)."""
                try:
                    if str(p).endswith(".gz"):
                        with gzip.open(p, "rb") as f:
                            head = f.read(65536)
                    else:
                        with open(p, "rb") as f:
                            head = f.read(65536)
                except OSError:
                    return 0
                if not head:
                    return 0
                total = est_syms(p, gz_mult)
                if _file_ext(Path(p)) in FILE_EXT_FASTQ:
                    dens = head.count(b"\n") / 4 / len(head)
                else:
                    dens = head.count(b">") / len(head)
                return int(dens * total * 1.5) + 4

            nt_in = [p for p in inputs
                     if _file_ext(Path(p)) in FILE_EXT_NUCLEOTIDE
                     or _file_ext(Path(p)) in FILE_EXT_FASTQ]
            aa_in = [p for p in inputs
                     if _file_ext(Path(p)) in FILE_EXT_PROTEIN]
            if nt_in:
                _start_prewarm(cfg.kmer, DNA_CODEC, cfg.min_count,
                               max(est_syms(p, 4.0) for p in nt_in),
                               max(est_records(p, 4.0) for p in nt_in))
            if aa_in or cfg.prodigal or cfg.fgs:
                hint = max((est_syms(p, 2.5) for p in aa_in), default=0)
                ghint = max((est_records(p, 2.5) for p in aa_in), default=0)
                if cfg.prodigal or cfg.fgs:
                    nt_syms = max((est_syms(p, 4.0) for p in nt_in),
                                  default=0)
                    hint = max(hint, nt_syms // 3)
                    # ~1 gene/kb in prokaryotes -> one gap range per gene
                    ghint = max(ghint, int(nt_syms / 1000 * 1.5) + 4)
                _start_prewarm(cfg.kmer, PROTEIN_CODEC, cfg.min_count,
                               hint, ghint)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = []
            for path in inputs:
                path = Path(path).expanduser().absolute()
                ext = _file_ext(path)
                basename = path.name.removesuffix(ext)
                if ext in FILE_EXT_FASTQ:
                    futures.append(("fastq", pool.submit(load_fastq, path, basename)))
                elif ext in FILE_EXT_NUCLEOTIDE:
                    futures.append(("fna", pool.submit(load_contig, path, basename)))
                    futures.append(
                        ("stats", pool.submit(
                            write_assembly_stats, path, out / "stats" / f"{basename}.txt"))
                    )
                elif ext in FILE_EXT_PROTEIN:
                    samples["protein"][basename] = [path]
            for kind, fut in futures:
                if kind == "fastq":
                    basename, fasta = fut.result()
                    samples["nucleotide"][basename] = [fasta]
                elif kind == "fna":
                    basename, cleaned, stat = fut.result()
                    samples["nucleotide"][basename] = [cleaned]
                    if stat:
                        gc_content[basename] = stat["GC Content"]
                else:
                    fut.result()

        n_files = len(samples["nucleotide"]) + len(samples["protein"])
        print(f"Time to load {n_files} files: {round(time.perf_counter() - t_start, 2)} seconds")
        debug.stage("load")

        fig_plots: dict = {}
        diversity_outputs: dict[str, list[Path]] = {}

        def process_round(sample_type: str, type_string: str) -> None:
            """chunk -> count -> figures -> diversity for one sample family."""
            group = samples[sample_type]
            if not group:
                return
            if cfg.chunk_size_mb > 0:
                dir_chunks = out / f"chunks_{sample_type}"
                for basename, files in group.items():
                    _, chunks = maybe_chunk(basename, files[0], cfg.chunk_size_mb,
                                            dir_chunks / basename)
                    group[basename] = chunks

            print(f"Processing {type_string}")
            out_tsv = out / (
                "tsv_nucleotide" if sample_type == "nucleotide" else f"tsv_{sample_type}"
            )
            out_tsv.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            codec, handles = _group_plan(group, cfg.kmer, workers)
            tsv_list: dict[str, Path] = {}
            if codec is not None:
                counter = KmerCounter(cfg.kmer, codec)
                # per-file tight buckets (eighth-pow2): the persistent compile
                # cache makes the handful of shapes cheap, and sort work drops
                # by up to 2x versus padding every file to the group max.
                try:
                    tsv_list = _count_group(group, counter, cfg.min_count,
                                            out_tsv, None, workers, handles,
                                            mesh=_resolve_mesh(cfg.mesh))
                finally:
                    for nf in handles.values():  # any not consumed by a build
                        nf.close()
            print(f"Time to count {cfg.kmer}-mers: {round(time.perf_counter() - t0, 2)} seconds")
            debug.stage(f"count {type_string}")

            if multi:
                # per-sample artifacts (alpha diversity) for OWN samples,
                # then sync; the coordinator re-reads every host's TSVs
                # from the shared tree for the combined stage.
                div_dir = report_dir / "diversity"
                div_dir.mkdir(parents=True, exist_ok=True)
                prefix = ("nucleotide" if sample_type == "nucleotide"
                          else sample_type)
                for basename, tsv in tsv_list.items():
                    outfile = div_dir / f"{prefix}-{basename}.tsv"
                    compute_alpha_diversity(basename, tsv, outfile,
                                            device=cfg.device_metrics)
                    diversity_outputs.setdefault(basename, []).append(outfile)
                barrier(f"count-{type_string}")
                if not coordinator:
                    return
                tsv_list = {
                    f.name.removesuffix("_counts.tsv"): f
                    for f in sorted(out_tsv.glob("*_counts.tsv"))
                }
                if tsv_list:
                    fig_plots.update(
                        _create_figures(tsv_list, type_string, out, cfg)
                    )
                    beta_dir = report_dir / (
                        "diversity" if sample_type == "nucleotide"
                        else "beta_diversity"
                    )
                    compute_beta_diversity(
                        type_string, out / f"combined_{type_string}_T.tsv",
                        beta_dir,
                    )
                return

            if tsv_list:
                fig_plots.update(_create_figures(tsv_list, type_string, out, cfg))
                beta_dir = report_dir / (
                    "diversity" if sample_type == "nucleotide" else "beta_diversity"
                )
                compute_beta_diversity(
                    type_string, out / f"combined_{type_string}_T.tsv", beta_dir
                )
            div_dir = report_dir / "diversity"
            div_dir.mkdir(parents=True, exist_ok=True)
            prefix = "nucleotide" if sample_type == "nucleotide" else sample_type
            for basename, tsv in tsv_list.items():
                outfile = div_dir / f"{prefix}-{basename}.tsv"
                compute_alpha_diversity(basename, tsv, outfile,
                                            device=cfg.device_metrics)
                diversity_outputs.setdefault(basename, []).append(outfile)

        # -- nucleotide round --
        process_round("nucleotide", "Nucleotide")
        if gc_content:
            fig_plots["Sample GC Summary"] = figs.gc_plot_sample(gc_content)

        # -- ORF calling (file-parallel: the callers are subprocess- or
        # numpy-bound, so a thread pool scales them like the reference's
        # Ray fan-out, /root/reference/bin/mercat2.py:368-407) --
        def orf_round(engine: str, outdir: Path, target: str) -> None:
            from mercat2_tpu.orf import orf_call

            items = list(samples["nucleotide"].items())
            # cap fan-out: each FragGeneScanRs subprocess peaks >1 GB on a
            # multi-Mbp genome, so unbounded file-parallelism multiplies
            # transient RSS (the gene-model caller is numpy-bound and
            # profits little beyond a few threads either way)
            fan = min(workers or 4, 4)
            with ThreadPoolExecutor(max_workers=fan) as pool:
                rets = pool.map(
                    lambda bf: orf_call(bf[0], bf[1][0], outdir, engine=engine),
                    items,
                )
                for ret in rets:
                    if ret:
                        samples[target][ret[0]] = [ret[1]]

        if cfg.prodigal and samples["nucleotide"]:
            print(f"\nRunning ORF caller on {len(samples['nucleotide'])} files")
            orf_round("prodigal", out / "pyrodigal", "prodigal")
        if cfg.fgs and samples["nucleotide"]:
            print(f"\nRunning FGS-style ORF caller on "
                  f"{len(samples['nucleotide'])} files")
            orf_round("fgs", out / "fgs", "fgs")

        # -- protein rounds --
        for sample_type in ("protein", "prodigal", "fgs"):
            process_round(sample_type, sample_type)

        if multi:
            barrier("rounds")
        if coordinator:
            # -- report --
            write_html(report_dir / "report.html", fig_plots, {})
            for sample_type in ("protein", "fgs", "prodigal"):
                if samples[sample_type]:
                    tsv_out = report_dir / f"metrics-{sample_type}.tsv"
                    htm_out = report_dir / f"metrics-{sample_type}.html"
                    metric_figs = figs.plot_sample_metrics(
                        samples[sample_type], tsv_out,
                        device=cfg.device_metrics)
                    write_html(htm_out, metric_figs, {})

            # -- merged per-sample diversity (ref bin/mercat2.py:479-499) --
            print("Gathering Diversity Metrics")
            if multi:
                # every host wrote {type}-{sample}.tsv to the shared tree
                div_files = sorted((report_dir / "diversity").glob("*-*.tsv"))
            else:
                div_files = [f for files in diversity_outputs.values()
                             for f in files]
            # reference merges per *type* across samples: diversity-{type}.tsv
            by_type: dict[str, dict[str, Path]] = {}
            for f in div_files:
                typ, _, sample = f.stem.partition("-")  # "{type}-{sample}"
                by_type.setdefault(typ, {})[sample] = f
            for typ, tomerge in by_type.items():
                if len(tomerge) >= 2:
                    key = "Nucleotide" if typ == "nucleotide" else typ
                    merge_tsv(tomerge, report_dir / f"diversity-{key}.tsv")
        if multi:
            barrier("finish")

        debug.stage("finish")

    with debug:  # always flush the jax profiler trace (try/finally)
        _body()
    print("\nFinished MerCat2 Pipeline")
    return out
