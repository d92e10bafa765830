"""On-device (jax) protein and alpha-diversity metrics.

The host implementations (metrics/protein.py, metrics/alpha.py) are the
bit-parity defaults; these jax versions compute the same quantities on the
accelerator for at-scale runs — millions of proteins batch through
``segment_sum`` + a vectorized bisection instead of a per-sequence Python
loop, and all nine alpha metrics evaluate in ONE device call over the
count vector. Enabled by the pipeline's ``-device-metrics`` flag.

Numerics: device arithmetic is float32 (JAX's default without x64), so
values can differ from the float64 host path in the last rounded digit;
parity tests bound the drift (pI within the solver's own 0.01 epsilon,
MW/hydropathy/diversity to ~1e-2 relative). The reference computes all of
this in Python floats on the host (/root/reference/lib/mercat2_metrics.py,
lib/mercat2_diversity.py:13-53).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mercat2_tpu.metrics import protein as _p

__all__ = [
    "protein_metrics_device",
    "alpha_metrics_device",
]


def _pad_pow2(n: int, floor: int = 256) -> int:
    return max(floor, 1 << (max(n - 1, 1)).bit_length())


@functools.partial(jax.jit, static_argnames=("n_seq",))
def _protein_metrics_jit(seq, seg_ids, first, last, n_seq: int):
    f32 = jnp.float32
    luts = {
        "qn1": jnp.asarray(_p._LUT_QN1, f32),
        "qp2": jnp.asarray(_p._LUT_QP2, f32),
    }
    seg = jax.ops.segment_sum

    def counts(ch: str):
        ind = (seq == ord(ch)).astype(f32)
        return seg(ind, seg_ids, num_segments=n_seq)

    # per-residue counts for every letter: exact f32 integers, so MW and
    # hydropathy become short dot products (count * constant) instead of
    # long f32 running sums whose error grows with chain length
    c = {ch: counts(ch) for ch in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"}
    mw = sum(
        c[ch] * f32(_p._MASS[ch]) for ch in _p._MASS
    ) + f32(_p._WATER)
    hyd = sum(c[ch] * f32(_p._HYDRO[ch]) for ch in _p._HYDRO)

    pka_first = luts["qn1"][first]
    pka_last = luts["qp2"][last]

    ph = jnp.full((n_seq,), 6.51, f32)
    ph_prev = jnp.zeros((n_seq,), f32)
    ph_next = jnp.full((n_seq,), 14.0, f32)
    result = jnp.full((n_seq,), jnp.nan, f32)
    done = jnp.isnan(pka_last)

    def body(_, state):
        ph, ph_prev, ph_next, result, done = state
        ten = f32(10.0)

        def q(pka, mult, positive):
            d = (ph - pka) if positive else (pka - ph)
            return mult / (1.0 + ten**d)

        nq = (
            -q(pka_first, 1.0, False)
            + q(pka_last, 1.0, True)
            - q(f32(_p._PKA_D), c["D"], False)
            - q(f32(_p._PKA_E), c["E"], False)
            - q(f32(_p._PKA_C), c["C"], False)
            - q(f32(_p._PKA_Y), c["Y"], False)
            + q(f32(_p._PKA_H), c["H"], True)
            + q(f32(_p._PKA_K), c["K"], True)
            + q(f32(_p._PKA_R), c["R"], True)
        )
        neg = nq < 0.0
        temp = ph
        ph = jnp.where(neg, ph - (ph - ph_prev) / 2.0,
                       ph + (ph_next - ph) / 2.0)
        ph_next = jnp.where(neg, temp, ph_next)
        ph_prev = jnp.where(neg, ph_prev, temp)
        conv = (~done) & (ph - ph_prev < 0.01) & (ph_next - ph < 0.01)
        result = jnp.where(conv, ph, result)
        done = done | conv
        return ph, ph_prev, ph_next, result, done

    state = (ph, ph_prev, ph_next, result, done)
    _, _, _, result, _ = jax.lax.fori_loop(0, 64, body, state)
    return result, mw, hyd


def protein_metrics_device(flat: np.ndarray, offsets: np.ndarray):
    """(pI, MW, hydropathy) float32 arrays for a batch of proteins.

    ``flat`` is the concatenated ASCII residue bytes, ``offsets`` the
    int64[n+1] chain boundaries (same layout as the host batch API).
    """
    n = offsets.size - 1
    if n == 0:
        z = np.zeros(0, np.float32)
        return z, z, z
    lens = np.diff(offsets)
    pad_syms = _pad_pow2(int(flat.shape[0]), 1024)
    pad_seq = _pad_pow2(n)
    seq = np.zeros(pad_syms, np.uint8)  # residue 0 maps to +0.0 everywhere
    seq[: flat.shape[0]] = flat
    seg_ids = np.full(pad_syms, pad_seq - 1, np.int32)  # padding -> last seg
    seg_ids[: flat.shape[0]] = np.repeat(
        np.arange(n, dtype=np.int32), lens
    )
    first = np.zeros(pad_seq, np.uint8)
    last = np.zeros(pad_seq, np.uint8)
    first[:n] = flat[offsets[:-1]]
    last[:n] = flat[offsets[1:] - 1]
    pi, mw, hyd = _protein_metrics_jit(
        seq, seg_ids, first, last, n_seq=pad_seq
    )
    return (np.asarray(pi)[:n], np.asarray(mw)[:n], np.asarray(hyd)[:n])


@jax.jit
def _alpha_jit(counts):
    """All nine alpha metrics over one padded count vector, one call.

    Returns a flat vector [shannon, simpson, simpson_e, goods, fisher,
    dominance, chao1, chao1_lo, chao1_hi, ace]; callers map failures
    (NaN/inf) to 'NA' like the host path.
    """
    f32 = jnp.float32
    c = counts.astype(f32)
    n = jnp.sum(c)
    obs = jnp.sum(c > 0)
    f1 = jnp.sum(c == 1)
    f2 = jnp.sum(c == 2)

    freqs = jnp.where(c > 0, c / n, 1.0)
    shannon = -jnp.sum(jnp.where(c > 0, freqs * jnp.log(freqs), 0.0)) / jnp.log(f32(2.0))
    dominance = jnp.sum((c / n) ** 2)
    simpson = 1.0 - dominance
    simpson_e = (1.0 / dominance) / obs
    goods = 1.0 - f1 / n

    # fisher alpha: bisection on g(a) = a*log1p(n/a) - obs, increasing in a
    def fisher_body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        g = mid * jnp.log1p(n / mid) - obs
        return jnp.where(g < 0, mid, lo), jnp.where(g < 0, hi, mid)

    lo, hi = jnp.asarray(1e-9, f32), jnp.asarray(1e12, f32)
    lo, hi = jax.lax.fori_loop(0, 100, fisher_body, (lo, hi))
    fisher = jnp.where(obs >= n, jnp.nan, 0.5 * (lo + hi))

    chao1 = obs + f1 * (f1 - 1) / (2.0 * (f2 + 1))

    # chao1 CI (bias-corrected branches, EstimateS formulas)
    var_12 = (
        f1 * (f1 - 1) / (2 * (f2 + 1))
        + f1 * (2 * f1 - 1) ** 2 / (4 * (f2 + 1) ** 2)
        + f1**2 * f2 * (f1 - 1) ** 2 / (4 * (f2 + 1) ** 4)
    )
    var_1 = (
        f1 * (f1 - 1) / 2.0
        + f1 * (2 * f1 - 1) ** 2 / 4.0
        - f1**4 / (4.0 * chao1)
    )
    var = jnp.where(f2 > 0, var_12, var_1)
    t = chao1 - obs
    k = jnp.exp(jnp.abs(
        f32(1.96) * jnp.sqrt(jnp.log(1 + var / jnp.maximum(t, 1e-12) ** 2))
    ))
    lo_ci = jnp.where(t == 0, obs, obs + t / k)
    hi_ci = jnp.where(t == 0, obs, obs + t * k)
    pz = jnp.exp(-n / obs)
    term = f32(1.96) * jnp.sqrt(obs * pz / (1 - pz))
    lo_ci = jnp.where(f1 > 0, lo_ci, jnp.maximum(obs, obs / (1 - pz) - term))
    hi_ci = jnp.where(f1 > 0, hi_ci, obs / (1 - pz) + term)

    # ACE, rare threshold 10
    rare = (c > 0) & (c <= 10)
    s_abun = jnp.sum(c > 10)
    s_rare = jnp.sum(rare)
    n_rare = jnp.sum(jnp.where(rare, c, 0.0))
    c_ace = 1 - f1 / n_rare
    i = jnp.arange(1, 11, dtype=f32)
    fi = jnp.sum((c[None, :] == i[:, None]).astype(f32), axis=1)
    top = jnp.sum(i * (i - 1) * fi)
    gamma = jnp.maximum(
        (s_rare / c_ace) * top / (n_rare * (n_rare - 1)) - 1, 0.0
    )
    ace = jnp.where(
        s_rare == 0, s_abun,
        jnp.where(f1 == n_rare, jnp.nan,
                  s_abun + s_rare / c_ace + (f1 / c_ace) * gamma),
    )
    return jnp.stack([
        shannon, simpson, simpson_e, goods, fisher, dominance,
        chao1, lo_ci, hi_ci, ace,
    ])


def alpha_metrics_device(counts: np.ndarray) -> dict:
    """All nine alpha metrics in one device call; 'NA' where undefined."""
    n = int(counts.shape[0])
    padded = np.zeros(_pad_pow2(n), np.int64)
    padded[:n] = counts
    v = np.asarray(_alpha_jit(padded))

    def val(x):
        return "NA" if not np.isfinite(x) else float(x)

    return {
        "shannon": val(v[0]),
        "simpson": val(v[1]),
        "simpson_e": val(v[2]),
        "goods_coverage": val(v[3]),
        "fisher_alpha": val(v[4]),
        "dominance": val(v[5]),
        "chao1": val(v[6]),
        "chao1_ci": (
            "NA" if not (np.isfinite(v[7]) and np.isfinite(v[8]))
            else (float(v[7]), float(v[8]))
        ),
        "ace": val(v[9]),
    }
