#!/usr/bin/env python3
"""End-to-end check that the MerCat2 count pipeline runs on the GPU.

Generates, from ``--seed``, a folder of bacterial-genome-sized assemblies
(gzipped multi-contig FASTA with N runs and repeat elements) and a folder
of proteomes, builds the native IO library from source, and runs the
normal entry point (``mercat2_tpu.cli.main``) over them in this process:

    -k 21 -c 10  genomes    uniform sort program, 2-word keys fused to u64
    -k 5  -c 10  genomes    one-hot dense histogram, 2-bit codes
    -k 3  -c 10  proteomes  sort program, 1-word 5-bit keys (26^3 bins is
                            above the dense threshold)
    -k 8  -c 2   proteomes  sort program, 5-bit serial key chain, u64 keys
    -k 2  -c 10  proteomes  one-hot dense histogram, 5-bit codes

Every per-sample count TSV must equal a plain numpy count of the same
input (``engine.counter._count_host`` over the numpy FASTA parser), and
the alpha/beta diversity tables and the HTML report must exist. The last
line of stdout is one JSON object: ``{"ok": ..., "device": {"platform",
"kind", "count"}}``.

    python chip_smoke.py                 # one GPU
    python chip_smoke.py --four          # four GPUs: the mesh path only
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse          # tiny, CPU
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse --four   # 4 virtual CPUs

Without an accelerator (and without ``--rehearse``) it exits non-zero and
its last line says ``"ok": false``.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: data sizes: "full" is what the GPU run uses, "rehearse" the CPU rehearsal
SIZES = {
    "full": dict(genomes=8, genome_bp=5_000_000, contigs=(20, 60),
                 elements=30, shared_elements=10, copies=12,
                 proteomes=8, proteins=4000, protein_len=300, domains=300),
    "rehearse": dict(genomes=4, genome_bp=250_000, contigs=(3, 8),
                     elements=6, shared_elements=3, copies=12,
                     proteomes=4, proteins=150, protein_len=120, domains=20),
}

#: (folder, k, min_count) of each single-GPU run
RUNS = [("nt", 21, 10), ("nt", 5, 10), ("aa", 3, 10), ("aa", 8, 2),
        ("aa", 2, 10)]
#: runs of the four-GPU mesh phase, each made twice (cold, then warm),
#: in rising order of device memory: a device's peak_bytes_in_use is its
#: peak since the process started, so a run's own peak shows only where it
#: rises past the earlier runs'
FOUR_RUNS = [("nt", 5, 10), ("nt", 21, 10)]

_DNA = np.frombuffer(b"ACGT", np.uint8)
#: amino acids with UniProt background frequencies (percent)
_AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
_AA_FREQ = np.array([8.25, 5.53, 4.06, 5.45, 1.37, 3.93, 6.75, 7.07, 2.27,
                     5.96, 9.66, 5.84, 2.42, 3.86, 4.70, 6.56, 5.34, 1.08,
                     2.92, 6.87])


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------


def _fasta_bytes(records: list[tuple[str, np.ndarray]], width: int) -> bytes:
    """FASTA text with sequence lines wrapped at ``width`` columns."""
    out = []
    for header, seq in records:
        out.append(b">" + header.encode() + b"\n")
        n = seq.shape[0]
        full = n // width
        if full:
            body = np.empty((full, width + 1), np.uint8)
            body[:, :width] = seq[: full * width].reshape(full, width)
            body[:, width] = ord("\n")
            out.append(body.tobytes())
        if n % width:
            out.append(seq[full * width:].tobytes() + b"\n")
    return b"".join(out)


def _genome(rng, sz: dict, shared: list[np.ndarray], name: str):
    """(header, bytes) contig records of one genome: random ACGT at a
    per-genome GC content, repeat elements (own and shared) copied
    ``copies`` times into disjoint slots, and N runs inside contigs."""
    n = sz["genome_bp"]
    gc = rng.uniform(0.35, 0.65)
    p = np.array([1 - gc, gc, gc, 1 - gc]) / 2
    g = _DNA[rng.choice(4, size=n, p=p)]
    own = [_DNA[rng.integers(0, 4, rng.integers(300, 1500))]
           for _ in range(sz["elements"])]
    elements = own + shared
    slot = 1500
    slots = rng.choice(n // slot - 1, size=len(elements) * sz["copies"],
                       replace=False)
    for i, s in enumerate(slots):
        e = elements[i % len(elements)]
        g[s * slot : s * slot + e.shape[0]] = e
    n_contigs = int(rng.integers(*sz["contigs"]))
    cuts = np.sort(rng.choice(np.arange(1000, n - 1000), n_contigs - 1,
                              replace=False))
    records = []
    for j, (a, b) in enumerate(zip(np.r_[0, cuts], np.r_[cuts, n])):
        contig = g[a:b].copy()
        for _ in range(int(rng.integers(0, 4))):
            at = int(rng.integers(0, contig.shape[0]))
            contig[at : at + int(rng.integers(10, 100))] = ord("N")
        records.append((f"{name}_contig{j + 1} length={b - a}", contig))
    return records


def _proteome(rng, sz: dict, domains: list[np.ndarray], name: str):
    """(header, bytes) records: background-frequency proteins starting
    with M, with shared domains spliced in and a '*' stop on half of
    them."""
    freq = _AA_FREQ / _AA_FREQ.sum()
    records = []
    for i in range(sz["proteins"]):
        length = int(np.clip(rng.normal(sz["protein_len"],
                                        sz["protein_len"] / 4), 50, 1000))
        prot = _AA[rng.choice(20, size=length, p=freq)]
        prot[0] = ord("M")
        for _ in range(int(rng.integers(0, 3))):
            d = domains[int(rng.integers(0, len(domains)))]
            at = int(rng.integers(1, max(2, length - d.shape[0])))
            prot[at : at + d.shape[0]] = d[: length - at]
        if rng.random() < 0.5:
            prot = np.append(prot, np.uint8(ord("*")))
        records.append((f"{name}_p{i + 1} hypothetical protein", prot))
    return records


def generate_inputs(out: Path, seed: int, sz: dict) -> tuple[Path, Path]:
    """Write the genome and proteome folders under ``out``; returns them."""
    rng = np.random.default_rng(seed)
    nt_dir, aa_dir = out / "genomes", out / "proteomes"
    nt_dir.mkdir(parents=True, exist_ok=True)
    aa_dir.mkdir(parents=True, exist_ok=True)
    shared = [_DNA[rng.integers(0, 4, rng.integers(300, 1500))]
              for _ in range(sz["shared_elements"])]
    for i in range(sz["genomes"]):
        name = f"genome{i + 1}"
        recs = _genome(rng, sz, shared, name)
        with gzip.open(nt_dir / f"{name}.fna.gz", "wb", compresslevel=1) as f:
            f.write(_fasta_bytes(recs, 80))
    freq = _AA_FREQ / _AA_FREQ.sum()
    domains = [_AA[rng.choice(20, size=int(rng.integers(20, 60)), p=freq)]
               for _ in range(sz["domains"])]
    for i in range(sz["proteomes"]):
        name = f"proteome{i + 1}"
        recs = _proteome(rng, sz, domains, name)
        with gzip.open(aa_dir / f"{name}.faa.gz", "wb", compresslevel=1) as f:
            f.write(_fasta_bytes(recs, 60))
    return nt_dir, aa_dir


# ---------------------------------------------------------------------------
# reference comparison
# ---------------------------------------------------------------------------


def read_counts_tsv(path: Path, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(k-mer S-array, int64 counts) of one per-sample count TSV."""
    lines = path.read_bytes().split(b"\n")[1:]
    lines = [ln for ln in lines if ln]
    kmers = np.array([ln[:k] for ln in lines], dtype=f"S{k}")
    counts = np.array([int(ln[k + 1:]) for ln in lines], dtype=np.int64)
    return kmers, counts


def reference_counts(fasta: Path, k: int, min_count: int):
    """Plain numpy count of one FASTA file: (k-mer S-array, counts)."""
    from mercat2_tpu.engine.counter import _count_host, _drop_short_records
    from mercat2_tpu.io.fasta import parse_fasta_seq_bytes, read_file_bytes

    seq, rec = parse_fasta_seq_bytes(read_file_bytes(fasta))
    seq, rec = _drop_short_records(seq, rec, k)
    if seq.shape[0] < k:
        return np.zeros(0, f"S{k}"), np.zeros(0, np.int64)
    table = _count_host(seq, rec, k, min_count)
    kmers = np.ascontiguousarray(table.kmers).view(f"S{k}").ravel()
    return kmers, table.counts


def _reference_worker() -> None:
    """Reference workers count on the host only: JAX must not claim the
    card in them (importing the package creates JAX constants)."""
    os.environ["JAX_PLATFORMS"] = "cpu"


def reference_pool(n: int):
    """Process pool for the numpy reference (spawned, host-only)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        max_workers=n, mp_context=multiprocessing.get_context("spawn"),
        initializer=_reference_worker)


def check_run(out: Path, kind: str, inputs: list[Path], k: int,
              min_count: int, pool=None) -> int:
    """Compare every sample's count TSV with the numpy reference (counted
    in ``pool`` when given) and check that the diversity tables and the
    report exist. Returns the number of k-mer rows compared."""
    from itertools import repeat

    rows = 0
    tsv_dir = out / ("tsv_nucleotide" if kind == "nt" else "tsv_protein")
    bases = [p.name.split(".")[0] for p in inputs]
    srcs = [out / "clean" / f"{b}_clean.fna.gz" if kind == "nt" else p
            for b, p in zip(bases, inputs)]
    refs = (pool.map if pool is not None else map)(
        reference_counts, srcs, repeat(k), repeat(min_count))
    for base, (want_k, want_c) in zip(bases, refs):
        tsv = tsv_dir / f"{base}_counts.tsv"
        if not want_k.size:
            if tsv.exists():
                raise AssertionError(f"{tsv}: reference has no k-mers")
            continue
        got_k, got_c = read_counts_tsv(tsv, k)
        if not (np.array_equal(got_k, want_k)
                and np.array_equal(got_c, want_c)):
            raise AssertionError(
                f"{tsv}: {got_k.size} rows differ from the numpy reference "
                f"({want_k.size} rows)")
        rows += int(want_k.size)
    report = out / "report"
    prefix, beta_dir, tag = (
        ("nucleotide", report / "diversity", "Nucleotide") if kind == "nt"
        else ("protein", report / "beta_diversity", "protein"))
    need = [report / "report.html",
            report / f"diversity-{'Nucleotide' if kind == 'nt' else 'protein'}.tsv"]
    need += [report / "diversity" / f"{prefix}-{p.name.split('.')[0]}.tsv"
             for p in inputs]
    need += [beta_dir / f"{m}-{tag}.tsv" for m in ("euclidean", "braycurtis")]
    missing = [str(p) for p in need if not p.exists()]
    if missing:
        raise AssertionError(f"missing outputs: {missing}")
    return rows


# ---------------------------------------------------------------------------
# device and phases
# ---------------------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return proc.stdout.strip().replace("\n", " | ") or proc.stderr.strip()


def build_native() -> None:
    """Build the native IO library from the committed source and check
    that it loads (so the numpy parse fallback cannot slip in)."""
    subprocess.run(["make", "-C", str(ROOT / "native"), "-B"], check=True,
                   capture_output=True, text=True)
    from mercat2_tpu.io.native import native_lib

    if native_lib() is None:
        raise RuntimeError("native IO library built but did not load")


def run_cli(argv: list[str]) -> float:
    from mercat2_tpu.cli import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}: {argv}")
    return time.perf_counter() - t0


def smoke(args, card: str) -> None:
    """All phases; raises on the first failure."""
    sz = SIZES["rehearse" if args.rehearse else "full"]
    out = Path(args.out).resolve()
    t0 = time.perf_counter()
    build_native()
    print(f"native IO built and loaded: {time.perf_counter() - t0:.3f} s",
          flush=True)
    t0 = time.perf_counter()
    nt_dir, aa_dir = generate_inputs(out / "inputs", args.seed, sz)
    folders = {"nt": nt_dir, "aa": aa_dir}
    mb = sum(p.stat().st_size for d in folders.values()
             for p in d.iterdir()) / 1e6
    print(f"inputs from seed {args.seed}: {sz['genomes']} genomes x "
          f"{sz['genome_bp']} bp, {sz['proteomes']} proteomes x "
          f"{sz['proteins']} proteins, {mb:.1f} MB gzipped, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    runs = FOUR_RUNS if args.four else RUNS
    with reference_pool(min(sz["genomes"], os.cpu_count() or 1)) as pool:
        for kind, k, c in runs:
            _run_and_check(args, card, folders, kind, k, c, out, pool)
            if args.four:  # warm: the same run without compiling
                _run_and_check(args, card, folders, kind, k, c, out, None,
                               warm=True)


def _peak_bytes() -> list[int]:
    """Each device's peak_bytes_in_use since the process started."""
    import jax

    return [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
            for d in jax.devices()]


def _run_and_check(args, card, folders, kind, k, c, out, pool,
                   warm: bool = False) -> None:
    """One CLI run, its wall time, and its comparison with the reference
    (a warm rerun is not compared again). Mesh runs also print each
    device's peak memory during the run: the peak where it rose past the
    earlier runs', else "<=" that earlier peak."""
    tag = f"{kind}_k{k}_c{c}"
    run_out = out / "runs" / tag
    argv = ["-k", str(k), "-c", str(c), "-f", str(folders[kind]),
            "-o", str(run_out), "-replace"]
    if args.four:
        argv += ["-mesh", "4"]
    before = _peak_bytes() if args.four else None
    wall = run_cli(argv)
    print(f"RUN {tag}{' -mesh 4' if args.four else ''}"
          f"{' warm' if warm else ''}: wall {wall:.3f} s [{card}]",
          flush=True)
    if args.four:
        after = _peak_bytes()
        peaks = [str(a) if a > b else f"<={b}" for a, b in zip(after, before)]
        print(f"run peak_bytes_in_use per device: [{', '.join(peaks)}]",
              flush=True)
    if warm:
        return
    t0 = time.perf_counter()
    inputs = sorted(folders[kind].iterdir())
    rows = check_run(run_out, kind, inputs, k, c, pool)
    print(f"CHECK {tag}: {len(inputs)} samples, {rows} k-mer rows equal "
          f"the numpy reference ({time.perf_counter() - t0:.3f} s)",
          flush=True)


def _fail(why: str, rc: int, device: dict | None = None) -> int:
    """Report a start-up failure: the reason on stderr, and ``"ok":
    false`` with the device found (null when none) as the last line."""
    print(f"chip_smoke: {why}", file=sys.stderr, flush=True)
    print(json.dumps({"ok": False, "device": device}), flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "smoke_out"),
                    help="directory for inputs and results")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes; the only mode that may run on the CPU")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device mesh path (-mesh 4)")
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu" if args.rehearse else "cuda")
    if args.rehearse and args.four and "device_count" not in os.environ.get(
            "XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=4")
    sys.path.insert(0, str(ROOT))
    try:
        import mercat2_tpu
    except ImportError as e:
        return _fail(f"mercat2_tpu is not importable next to this script: "
                     f"{e}", 2)
    if Path(mercat2_tpu.__file__).resolve().parent.parent != ROOT:
        return _fail("mercat2_tpu was imported from outside this checkout "
                     f"({mercat2_tpu.__file__})", 2)

    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        return _fail(f"JAX found no accelerator: {e}", 3)
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    if device["platform"] == "cpu" and not args.rehearse:
        return _fail("JAX found no accelerator (platform cpu); only "
                     "--rehearse runs on the CPU", 3, device)

    from mercat2_tpu.utils import enable_compilation_cache

    card = card_line() if device["platform"] == "gpu" else \
        f"no GPU ({device['platform']} rehearsal)"
    print(f"card: {card}")
    print(f"jax {jax.__version__}; devices: {device}")
    print(f"compile cache: {enable_compilation_cache()}", flush=True)

    ok = False
    try:
        if device["platform"] != "gpu" and not args.rehearse:
            raise RuntimeError(f"platform {device['platform']} is not gpu")
        if args.four and device["count"] < 4:
            raise RuntimeError(f"--four needs 4 devices, have {device['count']}")
        t0 = time.perf_counter()
        smoke(args, card)
        print(f"all phases passed in {time.perf_counter() - t0:.3f} s "
              f"[{card}]", flush=True)
        ok = True
    except Exception:  # every phase failure is reported and fails the run
        traceback.print_exc()
        sys.stderr.flush()
    print(json.dumps({"ok": ok, "device": device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
