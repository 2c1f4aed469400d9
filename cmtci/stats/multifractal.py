"""Multifractal box-counting spectrum D(q), tau(q), f(alpha) (T12).

Reference: multifractal_phase6.py:41-122 — box partition via integer keys,
Z(q, eps) partition sums over a q grid excluding q=1, tau(q) = slope of
log Z vs log eps, D(q) = tau/(q-1), Legendre alpha = dtau/dq,
f(alpha) = q*alpha - tau. Box counting (np.unique grouping) is host-side
(data-dependent sizes); the Z/regression math is vectorized. backend=
"device" replaces the host integer-key grouping with a fixed-shape dense
count grid + partition sums in ONE jit (all scales, all q) — the device path
for clouds beyond reference scale (VERDICT r3 item 8).
"""

from __future__ import annotations

import functools
from math import isclose

import jax
import jax.numpy as jnp
import numpy as np


def default_q_values():
    q = np.concatenate((np.linspace(-5, -1, 5), np.linspace(-0.8, 0.8, 9), np.linspace(1, 5, 5)))
    return np.array([v for v in q if not isclose(v, 1.0)])


def default_scales():
    return np.logspace(np.log10(0.002), np.log10(0.5), 12)


def box_counts(points, eps: float):
    """Counts per non-empty box of size eps (multifractal_phase6.py:41-56)."""
    pts = np.asarray(points, dtype=float)
    ix = np.floor((pts[:, 0] - pts[:, 0].min()) / eps).astype(np.int64)
    iy = np.floor((pts[:, 1] - pts[:, 1].min()) / eps).astype(np.int64)
    keys = ix * (10**9) + iy
    _, counts = np.unique(keys, return_counts=True)
    return counts


@functools.partial(jax.jit, static_argnames=("grid",))
def _z_device(x, y, scales, q_values, grid: int):
    """log Z(q, eps) partition sums on a fixed-shape device count grid.

    One scatter-add per scale into a grid² dense count field (the box keys
    of multifractal_phase6.py:41-56 with the same floor-of-shifted-coords
    partition), then log Σ p^q over non-empty boxes for every q — all
    scales in one lax.map, one device call. The sum runs in log-sum-exp
    form: the raw Σ p^q overflows f32 for q=-5 on multi-million-point
    clouds (a singleton box contributes n^5), while max|q·log p| ≈
    5·log n ≈ 76 keeps the shifted exponentials in range at any realistic
    n. Requires floor(range/eps) ≤ grid-1 boxes; callers check host-side.
    """
    xmin, ymin = x.min(), y.min()
    n = x.shape[0]

    def per_scale(eps):
        ix = jnp.clip(jnp.floor((x - xmin) / eps).astype(jnp.int32), 0, grid - 1)
        iy = jnp.clip(jnp.floor((y - ymin) / eps).astype(jnp.int32), 0, grid - 1)
        # int32 accumulation: f32 scatter-adds silently saturate per-box
        # counts at 2^24, exactly the multi-million-point scale this path
        # targets (same rationale as variogram._binned_sq_diff_masked)
        h = jnp.zeros(grid * grid, jnp.int32).at[ix * grid + iy].add(1)
        nonempty = jnp.sum(h > 0)
        hf = h.astype(x.dtype)
        logp = jnp.where(h > 0, jnp.log(hf) - jnp.log(jnp.asarray(n, x.dtype)), 0.0)

        def per_q(q):
            t = jnp.where(h > 0, q * logp, -jnp.inf)
            m = jnp.max(t)
            m = jnp.where(jnp.isfinite(m), m, 0.0)
            s = jnp.sum(jnp.where(h > 0, jnp.exp(t - m), 0.0))
            return jnp.where(q == 0,
                             jnp.log(nonempty.astype(x.dtype)),
                             m + jnp.log(s))

        return jax.lax.map(per_q, q_values), nonempty

    logz, nonempty = jax.lax.map(per_scale, scales)
    return logz.T, nonempty  # (n_q, n_scales), (n_scales,)


def box_counts_grid_device(points, scales, q_values, grid: int = 2048, dtype=None):
    """(Z, nonempty) for all (q, eps) via the device count grid."""
    pts = np.asarray(points, dtype=float)
    if np.iscomplexobj(np.asarray(points)):
        pts = np.column_stack([np.asarray(points).real.ravel(),
                               np.asarray(points).imag.ravel()])
    rng_x = pts[:, 0].max() - pts[:, 0].min()
    rng_y = pts[:, 1].max() - pts[:, 1].min()
    min_eps = float(np.min(scales))
    need = max(rng_x, rng_y) / min_eps
    # the max-coordinate point lands at index floor(range/eps) — its OWN
    # box in the host partition — so the grid needs floor(need)+1 boxes;
    # one extra box of slack absorbs f32 index rounding near the boundary
    # (need == grid used to pass the old `need > grid` check and alias the
    # edge points into the neighbouring box via the clip)
    if need >= grid - 1:
        raise ValueError(
            f"device grid {grid} too small for eps={min_eps:g} over range "
            f"{max(rng_x, rng_y):g} (needs ≥{int(np.ceil(need)) + 2}); raise "
            "grid= or drop the smallest scales")
    from cmtci.utils.device import analysis_dtype_ctx

    dt, x64_ctx = analysis_dtype_ctx(dtype)
    with x64_ctx:
        logz, nonempty = _z_device(jnp.asarray(pts[:, 0], dt), jnp.asarray(pts[:, 1], dt),
                                   jnp.asarray(scales, dt), jnp.asarray(q_values, dt),
                                   int(grid))
        # exponentiate in f64 on the host: the device carries log Z (f32
        # Z itself overflows for strongly negative q at large n)
        return np.exp(np.asarray(logz, np.float64)), np.asarray(nonempty)


def multifractal_spectrum(points, q_values=None, scales=None, min_count_boxes: int = 5,
                          backend: str = "host", grid: int = 2048, dtype=None):
    """Full multifractal analysis; returns dict(q, tau, Dq, alpha, f_alpha, scales, Z).

    backend="device" computes the box counts/partition sums on the default
    jax device (dtype=jnp.float32 for a GPU session); "host" is the
    reference-parity integer-key grouping."""
    pts = np.asarray(points)  # complex check BEFORE the float cast (which
    if np.iscomplexobj(pts):  # would silently drop the imaginary part)
        pts = np.column_stack([pts.real.ravel(), pts.imag.ravel()])
    pts = np.asarray(pts, dtype=float)
    q_values = default_q_values() if q_values is None else np.asarray(q_values, dtype=float)
    scales = default_scales() if scales is None else np.asarray(scales, dtype=float)

    z = np.zeros((len(q_values), len(scales)))
    valid = np.zeros(len(scales), dtype=bool)
    if backend == "device":
        z, nonempty = box_counts_grid_device(pts, scales, q_values, grid, dtype)
        z = np.array(z)  # np.asarray of a jax fetch can be read-only
        valid = nonempty >= min_count_boxes
        z[:, ~valid] = np.nan
    elif backend != "host":
        raise ValueError(f"unknown backend '{backend}'")
    else:
        for j, eps in enumerate(scales):
            counts = box_counts(pts, eps)
            if len(counts) < min_count_boxes:
                z[:, j] = np.nan
                continue
            valid[j] = True
            ps = counts / counts.sum()
            for i, q in enumerate(q_values):
                z[i, j] = ps.size if q == 0 else np.sum(ps**q)

    log_eps = np.log(scales[valid])
    tau = np.full(len(q_values), np.nan)
    dq = np.full(len(q_values), np.nan)
    for i, q in enumerate(q_values):
        y = np.log(z[i, valid])
        if np.any(np.isfinite(y)):
            a = np.vstack([log_eps, np.ones_like(log_eps)]).T
            m, _ = np.linalg.lstsq(a, y, rcond=None)[0]
            tau[i] = m
            dq[i] = m / (q - 1) if not isclose(q, 1.0) else np.nan

    alpha = np.gradient(tau, q_values, edge_order=2)
    f_alpha = q_values * alpha - tau
    return {"q": q_values, "tau": tau, "Dq": dq, "alpha": alpha,
            "f_alpha": f_alpha, "scales": scales, "Z": z}
