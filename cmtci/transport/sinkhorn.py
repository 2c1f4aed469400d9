"""Entropic OT alignment: kernel-argmax matcher and full log-space Sinkhorn.

Reference variants (S6, reimplemented):
  * "fixed" degenerate matcher — subsample both clouds to equal size, scale
    the distance matrix by its mean, K = exp(-M/eps), match = argmax over
    rows (a nearest-neighbor matcher; no iterations) —
    tci_construct_mandelbrot_v002_fixed.py:62-71
  * full Sinkhorn u/v iterations (eps=0.05, 1000 iters, SQUARED cdist) —
    tci_construct_mandelbrot-v002.py:60-72; POT ot.sinkhorn path —
    construct_stage1_clean.py:110-133

Device-first: the distance matrix is built blocked; the full Sinkhorn runs in
log space with lax.scan (numerically safe for small eps).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


from cmtci.utils.arrays import as_xy as _xy  # shared (N,2) coercion


@jax.jit
def _pairwise_dist(a, b):
    """Euclidean distances computed like cdist: sqrt of coordinate sums."""
    dx = a[:, 0][:, None] - b[:, 0][None, :]
    dy = a[:, 1][:, None] - b[:, 1][None, :]
    return jnp.sqrt(dx * dx + dy * dy)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _argmax_kernel_rows(a, b, mean, eps, chunk: int = 2048):
    """argmax_j exp(-(d_ij/mean)/eps) computed blocked over rows of a.

    Op order matches the reference (scale by mean, then by eps, then exp).
    """
    n = a.shape[0]
    npad = ((n + chunk - 1) // chunk) * chunk
    ap = jnp.pad(a, ((0, npad - n), (0, 0)))

    def body(i, out):
        rows = jax.lax.dynamic_slice_in_dim(ap, i * chunk, chunk, axis=0)
        d = _pairwise_dist(rows, b) / mean
        k = jnp.nan_to_num(jnp.exp(-d / eps))
        return jax.lax.dynamic_update_slice_in_dim(out, jnp.argmax(k, axis=1), i * chunk, axis=0)

    out = jnp.zeros(npad, dtype=jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
    out = jax.lax.fori_loop(0, npad // chunk, body, out)
    return out[:n]


@functools.partial(jax.jit, static_argnames=("chunk",))
def _match_fused(a, b, eps, chunk: int = 2048):
    """mean pairwise distance + kernel-argmax rows in ONE compiled call.

    Identical math to _blocked_mean_dist followed by _argmax_kernel_rows;
    fused so a tracker/TCI stage spends one dispatch on the matcher instead
    of two."""
    mean = _blocked_mean_dist(a, b, chunk=chunk)
    return _argmax_kernel_rows(a, b, mean, eps, chunk=chunk)


def entropic_argmax_match(x, y, eps: float = 0.8, rng=None, backend: str = "jax",
                          mesh=None, dtype=None):
    """tci_construct_mandelbrot_v002_fixed.py:62-71 semantics.

    Subsample the larger cloud to the smaller's size with numpy RNG (pass
    np.random or a RandomState to share the reference's global stream),
    normalize distances by their mean, and match each x to
    argmax_j exp(-d/eps). Returns (y[match], x) like the reference.

    backend="numpy" reproduces the reference's exact op order (scipy cdist,
    full K matrix) for bitwise oracle parity; backend="jax" computes the same
    match blocked on-device without materializing K. With a `mesh`, the row
    blocks are sharded over the devices (parallel.sharded.sharded_argmax_match,
    bitwise-identical to the single-device blocked path). `dtype` casts the
    device matcher's coordinates (float32 = the device fast path; the
    argmax realization shifts within the same rounding spread as the f32
    field path).
    """
    x = np.asarray(x)
    y = np.asarray(y)
    r = rng if rng is not None else np.random
    n, m = len(x), len(y)
    # complex 1-D inputs go through r.choice directly (the reference's exact
    # RNG stream); (N,2) arrays are subsampled by index (choice needs 1-D)
    if n > m:
        x = r.choice(x, m, replace=False) if x.ndim == 1 else x[r.choice(n, m, replace=False)]
    if m > n:
        y = r.choice(y, n, replace=False) if y.ndim == 1 else y[r.choice(m, n, replace=False)]
    ax, by = _xy(x), _xy(y)
    if dtype is not None and backend != "numpy":
        ax = np.asarray(ax, dtype=dtype)
        by = np.asarray(by, dtype=dtype)
    if backend == "numpy":
        from scipy.spatial.distance import cdist

        d = cdist(ax, by)
        d = d / d.mean()
        k = np.nan_to_num(np.exp(-d / eps))
        match = np.argmax(k, axis=1)
    elif mesh is not None:
        from cmtci.parallel.sharded import sharded_argmax_match

        from cmtci.utils.artifacts import fetch

        match = fetch(sharded_argmax_match(jnp.asarray(ax), jnp.asarray(by),
                                           eps, mesh))
    else:
        from cmtci.utils.artifacts import fetch

        match = fetch(_match_fused(jnp.asarray(ax), jnp.asarray(by), eps))
    return y[match], x


@functools.partial(jax.jit, static_argnames=("chunk",))
def _blocked_mean_dist(a, b, chunk: int = 2048):
    """Mean pairwise distance accumulated per block (no full N×M matrix)."""
    n = a.shape[0]
    npad = ((n + chunk - 1) // chunk) * chunk
    ap = jnp.pad(a, ((0, npad - n), (0, 0)))

    def body(i, acc):
        rows = jax.lax.dynamic_slice_in_dim(ap, i * chunk, chunk, axis=0)
        d = _pairwise_dist(rows, b)
        idx = i * chunk + jnp.arange(chunk)
        d = jnp.where((idx < n)[:, None], d, 0.0)
        return acc + jnp.sum(d)

    total = jax.lax.fori_loop(0, npad // chunk, body, jnp.zeros((), a.dtype))
    return total / (n * b.shape[0])


@functools.partial(jax.jit, static_argnames=("iters",))
def sinkhorn_log(cost, iters: int = 1000, eps: float = 0.05):
    """Log-domain Sinkhorn with uniform marginals; returns the plan.

    Equivalent (for well-scaled costs) to the reference's u/v iterations at
    tci_construct_mandelbrot-v002.py:60-72, but stable for small eps.
    """
    n, m = cost.shape
    log_mu = -jnp.log(n) * jnp.ones(n, dtype=cost.dtype)
    log_nu = -jnp.log(m) * jnp.ones(m, dtype=cost.dtype)
    mk = -cost / eps

    def body(carry, _):
        f, g = carry
        f = eps * (log_mu - jax.scipy.special.logsumexp(mk + g[None, :] / eps, axis=1))
        g = eps * (log_nu - jax.scipy.special.logsumexp(mk + f[:, None] / eps, axis=0))
        return (f, g), None

    (f, g), _ = jax.lax.scan(body, (jnp.zeros(n, cost.dtype), jnp.zeros(m, cost.dtype)), None, length=iters)
    return jnp.exp(mk + f[:, None] / eps + g[None, :] / eps)


def sinkhorn_match(x, y, eps: float = 0.05, iters: int = 1000, squared: bool = True):
    """Full-Sinkhorn barycentric matching: each x_i -> argmax_j plan_ij.

    Mirrors the original tci_construct_mandelbrot-v002.py intent (squared
    cdist cost). Returns (y[match], plan).
    """
    ax, by = _xy(x), _xy(y)
    d = np.asarray(_pairwise_dist(jnp.asarray(ax), jnp.asarray(by)))
    cost = d**2 if squared else d
    cost = cost / max(cost.mean(), 1e-300)
    plan = np.asarray(sinkhorn_log(jnp.asarray(cost), iters=iters, eps=eps))
    match = plan.argmax(axis=1)
    return np.asarray(y)[match], plan
