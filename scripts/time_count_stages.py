"""Device time of each stage of the k=21 uniform count program.

The pipeline counts k=21 DNA through ``count_kmers_packed`` at the
uniform transport shape (``KmerCounter._UNIFORM_SYMS`` symbols, 32 file
slots, 2-bit codes, output cap ``_UNIFORM_CAP``). This script jits each
stage of that program alone, at that shape, on seeded genome-like input:

    keys      packed words -> masked, fid-tagged key columns
    sort      the fused u64 sort
    finalize  run lengths + min-count filter + compaction
    program   the whole count_kmers_packed program

and checks that the staged result equals the program's. It also times
what the key build and the compaction were decided on:

    payload, validity        the key build's parts
    fid_compare_all/_scan    the per-window file id, compare-all search
                             against the default (scan) binary search
    keys_parent              the key build with the scan file ids
    compact_*                cumsum + scatter (the pipeline's), the
                             approx_min_k selector the pipeline used
                             before, and jnp.nonzero, on the program's own
                             survivor mask
    parent_program           the program traced with the scan file ids and
                             the approx_min_k compaction, as the pipeline
                             ran before; timed program, parent, parent,
                             program, and its output checked equal

Each time is the median of ``--reps`` batches of ``--inner`` back-to-back
calls ended by ``block_until_ready``, after a warm-up call; the first
call's time, compile included, is printed beside it.

    python scripts/time_count_stages.py            # on the GPU
    JAX_PLATFORMS=cpu python scripts/time_count_stages.py --syms 65536 --reps 2
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _genome_codes(rng, n: int) -> np.ndarray:
    """Random ACGT bytes with 200 repeat elements of 1 kbp copied 12 times
    each, so that min-count 10 keeps ~200K distinct 21-mers."""
    seq = rng.integers(0, 4, size=n, dtype=np.uint8)
    n_rep = max(1, min(200, n // 1000 // 24))
    reps = rng.integers(0, 4, size=(n_rep, 1000), dtype=np.uint8)
    slots = rng.choice(n // 1000 - 1, size=n_rep * 12, replace=False)
    for i, s in enumerate(slots):
        seq[s * 1000 : s * 1000 + 1000] = reps[i % n_rep]
    return np.frombuffer(b"ACGT", np.uint8)[seq]


#: approx_min_k segment size: local positions stay exactly representable
#: in float32 (< 2**24)
_SEG = 1 << 23


def _select_approx_min_k(keep, p: int, cap: int):
    """The compaction the pipeline used before cumsum + scatter: positions
    of the first ``cap`` survivors by approx_min_k at recall 1.0 over
    float32 positions, in 2**23-wide segments past 2**24 (fillers >= p)."""
    import jax
    import jax.numpy as jnp

    i32max = jnp.int32(2**31 - 1)
    pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    if cap * 4 > p:
        return jax.lax.sort(jnp.where(keep, pos, i32max))[:cap]
    if p <= (1 << 24):
        fpos = jnp.where(keep, pos.astype(jnp.float32), jnp.float32(1 << 24))
        vals, _ = jax.lax.approx_min_k(fpos, cap, recall_target=1.0)
        return jax.lax.sort(vals).astype(jnp.int32)
    local = jax.lax.broadcasted_iota(jnp.int32, (_SEG,), 0).astype(jnp.float32)
    winners = []
    for h in range(-(-p // _SEG)):
        lo = h * _SEG
        seg_len = min(_SEG, p - lo)
        seg_keep = jax.lax.slice_in_dim(keep, lo, lo + seg_len)
        fpos = jnp.where(seg_keep, local[:seg_len], jnp.float32(1 << 24))
        vals, _ = jax.lax.approx_min_k(fpos, min(cap, seg_len),
                                       recall_target=1.0)
        winners.append(jnp.where(vals < jnp.float32(1 << 24),
                                 vals.astype(jnp.int32) + lo, i32max))
    return jax.lax.sort(jnp.concatenate(winners))[:cap]


def _select_nonzero(keep, p: int, cap: int):
    """Positions of the first ``cap`` survivors by ``jnp.nonzero``."""
    import jax.numpy as jnp

    return jnp.nonzero(keep, size=cap, fill_value=p)[0].astype(jnp.int32)


def _file_ids_scan(file_starts, p: int):
    """Per-window file id by the default (scan) binary search."""
    import jax
    import jax.numpy as jnp

    pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    return jnp.searchsorted(file_starts, pos, side="right").astype(
        jnp.uint32) - 1


@contextlib.contextmanager
def _parent_form(fin):
    """Trace the count program with the scan file ids and the approx_min_k
    compaction in place of the pipeline's own."""
    saved = fin.window_file_ids, fin._select_first_positions
    fin.window_file_ids = _file_ids_scan
    fin._select_first_positions = _select_approx_min_k
    try:
        yield
    finally:
        fin.window_file_ids, fin._select_first_positions = saved


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def _time(fn, *args, reps: int, inner: int) -> tuple[float, float]:
    """(first call incl. compile, median steady-state seconds per call)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / inner)
    return first, float(np.median(samples))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--syms", type=int, default=None,
                    help="transport symbols (default: the uniform shape)")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--inner", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from mercat2_tpu.engine.codec import DNA_CODEC
    from mercat2_tpu.engine.counter import KmerCounter, NumpySource
    from mercat2_tpu.ops import finalize as fin

    k, min_count = 21, 10
    counter = KmerCounter(k, DNA_CODEC)
    n_sym = counter._uniform_n_sym(args.syms)
    n_files = counter._UNIFORM_FILES
    cap = counter._UNIFORM_CAP
    dev = jax.devices()[0]
    card = _card()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f" | card: {card} | jax {jax.__version__}", flush=True)

    # two genome-sized files of multi-contig sequence, as one uniform wave
    rng = np.random.default_rng(args.seed)
    sources = []
    per_file = (n_sym - 1024) // 2
    for _ in range(2):
        seq = _genome_codes(rng, per_file)
        rec = np.repeat(np.arange(50), -(-per_file // 50))[:per_file]
        sources.append(NumpySource(seq, rec.astype(np.int64), DNA_CODEC))
    group = counter.build_packed_group(
        sources, bucket=n_sym, gap_slots=counter._UNIFORM_GAP_FAMILIES[0],
    )
    starts = np.full(n_files, group.n_sym, np.int32)
    starts[: len(sources)] = group.file_starts
    dargs = (jnp.asarray(group.words), jnp.asarray(group.gap_begin),
             jnp.asarray(group.gap_end), jnp.asarray(starts))
    mc = jnp.int32(min_count)

    @jax.jit
    def keys(w, gb, ge, fs):
        keyed, n_valid, _ = fin.packed_keyed_words(
            w, gb, ge, fs, k=k, bits=2, n_files=n_files, n_sym=n_sym)
        return tuple(keyed), n_valid

    def program(w, gb, ge, fs, m):
        return fin.count_kmers_packed(
            w, gb, ge, fs, m, k=k, bits=2, alphabet_size=4, cap=cap,
            n_files=n_files, n_sym=n_sym)

    median_ms: dict = {}

    def record(name, fn, *a):
        first, med = _time(fn, *a, reps=args.reps, inner=args.inner)
        median_ms[name] = med * 1e3
        print(f"{name:<20} median {med * 1e3:10.4f} ms   first call (with "
              f"compile) {first:8.3f} s   [{card}]", flush=True)

    record("keys", keys, *dargs)
    keyed, n_valid = keys(*dargs)
    with jax.enable_x64(True):
        sort = jax.jit(lambda kd: fin._sort_fused_u64(list(kd)))
        record("sort", sort, keyed)
        s = sort(keyed)
        finalize = jax.jit(
            lambda s, nv, m: fin._finalize_sorted_u64(s, nv, m, cap))
        record("finalize", finalize, s, n_valid, mc)
        out_keys, out_counts, n_out = finalize(s, n_valid, mc)
    record("program", program, *dargs, mc)
    n_out = int(n_out)
    share = {n: median_ms[n] / median_ms["program"]
             for n in ("keys", "sort", "finalize")}
    print("share of program: " + ", ".join(
        f"{n} {v:.3f}" for n, v in share.items()), flush=True)

    # the program's output must equal the staged output
    w_prog, c_prog, n_prog = program(*dargs, mc)
    assert int(n_prog) == n_out
    m = min(n_out, cap)
    with jax.enable_x64(True):
        ok_hi, ok_lo = fin._split_u64(out_keys)
    assert np.array_equal(np.asarray(ok_hi)[:m], np.asarray(w_prog[0])[:m])
    assert np.array_equal(np.asarray(ok_lo)[:m], np.asarray(w_prog[1])[:m])
    assert np.array_equal(np.asarray(out_counts)[:m], np.asarray(c_prog)[:m])
    print(f"staged == program: n_valid {int(n_valid)} n_out {n_out}",
          flush=True)

    # the key build's parts, and the file-id search it was decided on
    p = n_sym - k + 1
    w, gb, ge, fs = dargs
    record("payload", jax.jit(
        lambda w: tuple(fin.packed_payload_words(w, k, 2, n_sym))), w)
    record("validity", jax.jit(
        lambda gb, ge: fin.packed_window_validity(gb, ge, k, p)), gb, ge)
    fid_all = jax.jit(lambda fs: fin.window_file_ids(fs, p))
    fid_scan = jax.jit(lambda fs: _file_ids_scan(fs, p))
    record("fid_compare_all", fid_all, fs)
    record("fid_scan", fid_scan, fs)
    assert np.array_equal(np.asarray(fid_all(fs)), np.asarray(fid_scan(fs)))
    with _parent_form(fin):
        # a new function: a jit of keys.__wrapped__ would share its trace
        keys_parent = jax.jit(lambda *a: keys.__wrapped__(*a))
        record("keys_parent", keys_parent, *dargs)

    # compaction of the program's own survivor mask
    with jax.enable_x64(True):
        @jax.jit
        def survivors(s, nv, m):
            pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
            marker = jnp.full((p,), jnp.uint64(2**64 - 1), jnp.uint64)
            start = jnp.concatenate(
                [jnp.ones((1,), bool), s[1:] != s[:-1]]) & (pos < nv)
            fwd = jax.lax.dynamic_slice(
                jnp.concatenate([s, marker]), (jnp.clip(m - 1, 0, p),), (p,))
            return start & (fwd == s)

        keep = survivors(s, n_valid, mc)
    assert int(jnp.sum(keep)) == n_out
    picked = {}
    for name, sel in (("compact_scatter", fin._select_first_positions),
                      ("compact_approx_min_k", _select_approx_min_k),
                      ("compact_nonzero", _select_nonzero)):
        fn = jax.jit(functools.partial(sel, p=p, cap=cap))
        record(name, fn, keep)
        picked[name] = np.asarray(fn(keep))[:m]
    for name, got in picked.items():
        assert np.array_equal(got, picked["compact_scatter"]), name

    # the whole program as it ran before, bracketed by the pipeline's own
    with _parent_form(fin):
        parent = jax.jit(functools.partial(
            fin.count_kmers_packed.__wrapped__, k=k, bits=2, alphabet_size=4,
            cap=cap, n_files=n_files, n_sym=n_sym))
        record("parent_program", parent, *dargs, mc)
        record("parent_program_2", parent, *dargs, mc)
        w_par, c_par, n_par = parent(*dargs, mc)
    record("program_2", program, *dargs, mc)
    assert int(n_par) == n_out
    assert np.array_equal(np.asarray(w_par[0])[:m], np.asarray(w_prog[0])[:m])
    assert np.array_equal(np.asarray(w_par[1])[:m], np.asarray(w_prog[1])[:m])
    assert np.array_equal(np.asarray(c_par)[:m], np.asarray(c_prog)[:m])
    print(f"parent_program == program: n_out {n_out}, count checksum "
          f"{int(np.asarray(c_prog)[:m].sum())}", flush=True)
    print(f"keys share of program: {share['keys']:.3f}; keys_parent share "
          f"of parent_program: "
          f"{median_ms['keys_parent'] / median_ms['parent_program']:.3f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
