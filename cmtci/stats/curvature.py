"""Boundary curvature estimators (T1-T3), vectorized/vmapped.

Reference behavior (reimplemented):
  * local-polynomial paper estimator (±m window, signed local arclength,
    quadratic least squares in x(s), y(s), κ = |x'y''-y'x''|/speed³) —
    boundary_curvature_localpoly.py:65-184
  * quick gradient estimator — spatial_stats_phase3.py:18-25
  * PCA-eccentricity proxy (kNN covariance λ_min/Σλ) —
    tci_construct_mandelbrot_v002_fixed.py:100-108

Device-first: the per-point Python loop becomes one batched windowed gather +
a vmapped 3x3 normal-equation solve.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _solve3(m, b):
    """Batched 3x3 linear solve by cofactor expansion. m: (N,3,3), b: (N,3)."""
    a00, a01, a02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    a10, a11, a12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    a20, a21, a22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    x0 = (c00 * b[:, 0] + c10 * b[:, 1] + c20 * b[:, 2]) / det
    x1 = (c01 * b[:, 0] + c11 * b[:, 1] + c21 * b[:, 2]) / det
    x2 = (c02 * b[:, 0] + c12 * b[:, 1] + c22 * b[:, 2]) / det
    return jnp.stack([x0, x1, x2], axis=-1)


def _window_indices(n: int, m: int, closed: bool):
    offs = np.arange(-m, m + 1)
    idx = np.arange(n)[:, None] + offs[None, :]
    if closed:
        return idx % n
    return np.clip(idx, 0, n - 1)


@functools.partial(jax.jit, static_argnames=("m",))
def _localpoly_core(xy_win, m: int):
    """xy_win: (N, 2m+1, 2) windowed points; returns curvature fields."""
    mid = m
    seg = jnp.linalg.norm(xy_win[:, 1:, :] - xy_win[:, :-1, :], axis=-1)  # (N, 2m)
    # signed arclength with s=0 at the window center
    cum = jnp.concatenate([jnp.zeros_like(seg[:, :1]), jnp.cumsum(seg, axis=1)], axis=1)
    s = cum - cum[:, mid : mid + 1]  # (N, 2m+1)

    ones = jnp.ones_like(s)
    a = jnp.stack([ones, s, s * s], axis=-1)  # (N, W, 3)
    ata = jnp.einsum("nwi,nwj->nij", a, a)
    atx = jnp.einsum("nwi,nw->ni", a, xy_win[..., 0])
    aty = jnp.einsum("nwi,nw->ni", a, xy_win[..., 1])
    # closed-form batched 3x3 solve (Cramer): the elementwise form is
    # faster than a batched linalg.solve
    cx = _solve3(ata, atx)
    cy = _solve3(ata, aty)

    x1, x2 = cx[:, 1], 2.0 * cx[:, 2]
    y1, y2 = cy[:, 1], 2.0 * cy[:, 2]
    cross = x1 * y2 - y1 * x2
    speed = jnp.sqrt(x1 * x1 + y1 * y1) + 1e-16
    kappa_signed = cross / speed**3
    return jnp.abs(kappa_signed), kappa_signed, speed, x1, y1, x2, y2


def localpoly_curvature(p, neighbors: int = 7, closed: bool = True):
    """Paper curvature estimator. Returns (kappa, kappa_signed, speed, aux).

    Matches boundary_curvature_localpoly.py:133-184 (stride=1); the
    quadratic fit solves the normal equations (vs lstsq/SVD in the
    reference — identical to ~1e-10 for these well-conditioned windows).
    """
    p = np.asarray(p, dtype=float)
    n = p.shape[0]
    m = int(neighbors)
    if m < 2:
        raise ValueError("neighbors must be >= 2 for a meaningful quadratic fit.")
    if n < 2 * m + 1:
        raise ValueError(f"Need at least {2*m+1} points; got {n}.")

    idx = _window_indices(n, m, closed)
    kappa, ks, speed, x1, y1, x2, y2 = _localpoly_core(jnp.asarray(p)[idx], m)
    aux = dict(xprime=np.asarray(x1), yprime=np.asarray(y1), x2=np.asarray(x2), y2=np.asarray(y2))
    return np.asarray(kappa), np.asarray(ks), np.asarray(speed), aux


def gradient_curvature(p):
    """np.gradient-based estimator (spatial_stats_phase3.py:18-25)."""

    p = jnp.asarray(p, dtype=jnp.float64)
    dx = jnp.gradient(p[:, 0])
    dy = jnp.gradient(p[:, 1])
    ddx = jnp.gradient(dx)
    ddy = jnp.gradient(dy)
    return np.asarray(jnp.abs(dx * ddy - dy * ddx) / (dx**2 + dy**2) ** 1.5)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _pca_ecc(xy, k: int, chunk: int = 2048):
    """Blocked: O(chunk·N) distance memory, not the N² matrix (a 25k-point
    f64 cloud would otherwise materialize 5 GB; same chunking pattern as
    embeddings._knn). Row-wise top-k is identical to the one-shot form."""
    n = xy.shape[0]
    npad = ((n + chunk - 1) // chunk) * chunk
    xp = jnp.pad(xy, ((0, npad - n), (0, 0)))  # pad rows discarded below

    def body(i, acc):
        blk = jax.lax.dynamic_slice_in_dim(xp, i * chunk, chunk, axis=0)
        d2 = jnp.sum((blk[:, None, :] - xy[None, :, :]) ** 2, axis=-1)
        _, idx = jax.lax.top_k(-d2, k)  # k nearest incl. self
        neigh = xy[idx]  # (chunk, k, 2)
        z = neigh - neigh.mean(axis=1, keepdims=True)
        cov = jnp.einsum("nki,nkj->nij", z, z) / (k - 1)
        # closed-form symmetric 2x2 eigenvalues (no lapack dependency):
        # λ = m ± sqrt(((a-d)/2)² + b²)
        a, b, d = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
        m = 0.5 * (a + d)
        s = jnp.sqrt(jnp.maximum(0.25 * (a - d) ** 2 + b * b, 0.0))
        lam_min, tr = m - s, a + d
        tiny = jnp.asarray(1e-300 if xy.dtype == jnp.float64 else 1e-30, xy.dtype)
        return jax.lax.dynamic_update_slice_in_dim(
            acc, lam_min / jnp.maximum(tr, tiny), i * chunk, axis=0)

    out = jnp.zeros(npad, dtype=xy.dtype)
    return jax.lax.fori_loop(0, npad // chunk, body, out)[:n]


def pca_eccentricity(pts, k: int = 6, dtype=None):
    """kNN covariance λ_min/Σλ (tci_construct_mandelbrot_v002_fixed.py:100-108).

    The reference queries a KDTree per point; here it's a chunked dense
    top-k (O(chunk·N) memory). dtype=None runs f64; dtype=jnp.float32 is
    the fast path the 4x-grid TCI pipeline uses (the eccentricity feeds a correlation
    coefficient; f32 is far below that statistic's sampling noise).
    """

    pts = np.asarray(pts)
    if np.iscomplexobj(pts):
        xy = np.column_stack([pts.real.ravel(), pts.imag.ravel()])
    else:
        xy = pts
    if dtype is not None and dtype != jnp.float64:
        with jax.enable_x64(False):
            return np.asarray(_pca_ecc(jnp.asarray(xy, dtype), int(k)))
    return np.asarray(_pca_ecc(jnp.asarray(xy), int(k)))
