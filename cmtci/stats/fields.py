"""Grid-field Laplacians and global/local correlation maps (T21).

Reference:
  * 5-point roll Laplacian / h² — Laplacian_C-M.py:49-59,
    Iterative_Variogram_Laplacian.py:132-137
  * global Pearson r — Potentials.py:63-70
  * sliding-window local Pearson correlation map (half-window win, window
    slice [i-win:i+win] of size 2*win) — Potentials.py:77-95

Device-first: the reference's pure-Python double loop over pixels becomes
box-filter moment sums (one pass of cumulative sums), mathematically equal
to the per-window Pearson r.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def laplacian5(u, h):
    """(-4u + roll sums)/h² with wraparound, matching np.roll semantics."""
    u = jnp.asarray(u)
    return (
        -4.0 * u
        + jnp.roll(u, 1, axis=0) + jnp.roll(u, -1, axis=0)
        + jnp.roll(u, 1, axis=1) + jnp.roll(u, -1, axis=1)
    ) / (h * h)


def pearson_global(a, b) -> float:
    a = np.asarray(a, dtype=float).ravel()
    b = np.asarray(b, dtype=float).ravel()
    m = ~(np.isnan(a) | np.isnan(b))
    a, b = a[m], b[m]
    am, bm = a.mean(), b.mean()
    return float(((a - am) * (b - bm)).sum() / np.sqrt(((a - am) ** 2).sum() * ((b - bm) ** 2).sum()))


def pearson_global_device(a, b):
    """Traced/on-device Pearson r over the jointly-finite pixels.

    Same masked statistic as pearson_global (Potentials.py:63-70) but kept
    inside the caller's jit so f32 diagnostic paths never leave the
    accelerator; means are subtracted before the products so f32 sums
    don't cancel catastrophically."""
    valid = jnp.isfinite(a) & jnp.isfinite(b)
    n = jnp.maximum(valid.sum().astype(a.dtype), 1)
    a0 = jnp.where(valid, a, 0.0)
    b0 = jnp.where(valid, b, 0.0)
    ac = jnp.where(valid, a0 - a0.sum() / n, 0.0)
    bc = jnp.where(valid, b0 - b0.sum() / n, 0.0)
    return (ac * bc).sum() / jnp.sqrt((ac * ac).sum() * (bc * bc).sum())


def _box_sum(x, win: int):
    """Sum over the window [i-win, i+win) x [j-win, j+win) per interior pixel."""
    c = jnp.cumsum(jnp.cumsum(x, axis=0), axis=1)
    c = jnp.pad(c, ((1, 0), (1, 0)))
    ny, nx = x.shape
    # window rows [i-win, i+win) -> cumsum indices (i+win) - (i-win)
    i = jnp.arange(win, ny - win)
    j = jnp.arange(win, nx - win)
    top = i - win
    bot = i + win
    lef = j - win
    rig = j + win
    return (c[bot][:, rig] - c[bot][:, lef] - c[top][:, rig] + c[top][:, lef])


@functools.partial(jax.jit, static_argnames=("win",))
def _local_corr(u1, u2, win: int):
    # per-window Pearson over the jointly-non-NaN pixels, like the
    # reference's mask = ~(isnan(a)|isnan(b)) + pearsonr (Potentials.py:
    # 89-91); windows with <= 5 valid pixels stay NaN (":91 sum(mask) > 5")
    valid = jnp.isfinite(u1) & jnp.isfinite(u2)
    a = jnp.where(valid, u1, 0.0)
    b = jnp.where(valid, u2, 0.0)
    n = _box_sum(valid.astype(u1.dtype), win)
    ns = jnp.maximum(n, 1.0)
    s1 = _box_sum(a, win)
    s2 = _box_sum(b, win)
    s11 = _box_sum(a * a, win)
    s22 = _box_sum(b * b, win)
    s12 = _box_sum(a * b, win)
    cov = s12 - s1 * s2 / ns
    v1 = s11 - s1 * s1 / ns
    v2 = s22 - s2 * s2 / ns
    denom = jnp.sqrt(jnp.maximum(v1 * v2, 0.0))
    return jnp.where((n > 5) & (denom > 0), cov / denom, jnp.nan)


def local_correlation(u1, u2, win: int = 15):
    """Local Pearson map (Potentials.py:77-95). NaN outside the valid frame
    and wherever a window has <= 5 jointly-non-NaN pixels."""
    u1 = jnp.asarray(u1, dtype=jnp.float64)
    u2 = jnp.asarray(u2, dtype=jnp.float64)
    ny, nx = u1.shape
    out = np.full((ny, nx), np.nan)
    inner = np.asarray(_local_corr(u1, u2, int(win)))
    out[win : ny - win, win : nx - win] = inner
    return out
