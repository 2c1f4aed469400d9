"""Logarithmic potential of a point cloud on a grid (blocked reduction).

Covers the reference's three conventions (SURVEY.md §2.1 K8):
  * U = +(1/N) Σ log(|z-p| + eps), eps=1e-12   — Potentials.py:19-27
  * U = -(1/N) Σ log(|z-p| + eps), eps=1e-12   — Laplacian_C-M.py:16-24
  * U = (1/N) Σ log(1/(|z-p| + eps)), eps=1e-6 — variograms_construct_mandelbrot.py:128-146

The O(H·W·N) pairwise work is blocked over point chunks so device/host memory
stays bounded; padding lanes carry zero weight.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("chunk", "sign"))
def _accumulate(gx, gy, px, py, w, eps, sign: int, chunk: int):
    n_pad = px.shape[0]
    u0 = jnp.zeros_like(gx)

    def body(i, u):
        pr = jax.lax.dynamic_slice_in_dim(px, i * chunk, chunk)
        pi = jax.lax.dynamic_slice_in_dim(py, i * chunk, chunk)
        ww = jax.lax.dynamic_slice_in_dim(w, i * chunk, chunk)
        dx = gx[:, :, None] - pr[None, None, :]
        dy = gy[:, :, None] - pi[None, None, :]
        r = jnp.sqrt(dx * dx + dy * dy) + eps
        term = jnp.log(r) if sign > 0 else jnp.log(1.0 / r)
        return u + jnp.sum(term * ww[None, None, :], axis=-1)

    return jax.lax.fori_loop(0, n_pad // chunk, body, u0)


def cloud_log_potential(gx, gy, pts, eps: float = 1e-12, sign: int = 1, chunk: int = 2048):
    """U(z) = sign * (1/N) Σ log(|z-p_k| + eps) over grid (gx, gy).

    pts: complex array or (N,2) real array. sign=+1 matches Potentials.py,
    sign=-1 matches Laplacian_C-M.py / the variogram script's log(1/r) form.
    """
    pts = np.asarray(pts)
    if np.iscomplexobj(pts):
        px, py = pts.real.ravel(), pts.imag.ravel()
    else:
        px, py = pts[:, 0], pts[:, 1]
    n = px.shape[0]
    if n == 0:
        return jnp.zeros_like(jnp.asarray(gx))
    n_pad = ((n + chunk - 1) // chunk) * chunk
    pad = n_pad - n
    dt = np.asarray(gx).dtype if not hasattr(gx, "dtype") else gx.dtype
    # points and weights follow the grid's dtype (an f32 grid selects the
    # f32 path end-to-end; mixed inputs would upcast the carry)
    gxj = jnp.asarray(gx)
    px = jnp.asarray(np.pad(px, (0, pad)), dtype=gxj.dtype)
    py = jnp.asarray(np.pad(py, (0, pad)), dtype=gxj.dtype)
    w = jnp.asarray(np.pad(np.ones(n), (0, pad)), dtype=gxj.dtype)
    u = _accumulate(gxj, jnp.asarray(gy, dtype=gxj.dtype), px, py, w,
                    gxj.dtype.type(eps), 1 if sign > 0 else -1, chunk)
    return u / n
