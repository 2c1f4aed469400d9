"""TCI / GI-flow: histogram mixture iteration with KL tracking (S8).

Reference: X <- (1-alpha) X + alpha P.
  * fixed-T with kl0/klT — gi_assumption_tracker_v3.py:128-134
  * adaptive-to-threshold with min_steps — :137-148
  * trajectory-capturing tci_flow — tci_construct_mandelbrot_v002_fixed.py:90-95

The fixed-T variant is a lax.scan, the adaptive one a lax.while_loop; both
jittable (the KL uses the reference's clip-at-eps form).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cmtci.transport.histogram import kl


def _kl_jit(p, x, eps):
    p = jnp.clip(p, eps, None)
    x = jnp.clip(x, eps, None)
    return jnp.sum(p * (jnp.log(p) - jnp.log(x)))


@functools.partial(jax.jit, static_argnames=("t_steps",))
def _fixed_t(p, x0, alpha, t_steps: int, eps):
    kl0 = _kl_jit(p, x0, eps)

    def body(x, _):
        return (1.0 - alpha) * x + alpha * p, None

    x, _ = jax.lax.scan(body, x0, None, length=t_steps)
    return x, kl0, _kl_jit(p, x, eps)


def gi_flow_fixed_t(p, x0, alpha: float, t_steps: int, eps: float = 1e-12,
                    host_numpy: bool = False):
    """Returns (X_T, T, kl0, klT) — gi_assumption_tracker_v3.py:128-134.

    host_numpy=True runs the identical mixture loop in numpy (no XLA-CPU
    dispatch — the tracker fast path's stages contend with its background
    eigensweeps for the host stream; only KL endpoints are computed, so
    the numpy loop is O(T·bins²) mults and cheap at every stage size)."""
    if host_numpy:
        from cmtci.transport.histogram import kl as _kl_np

        p = np.asarray(p)
        x = np.asarray(x0)
        kl0 = _kl_np(p, x, eps)
        for _ in range(int(t_steps)):
            x = (1.0 - alpha) * x + alpha * p
        return x, int(t_steps), float(kl0), float(_kl_np(p, x, eps))

    x, kl0, klt = _fixed_t(jnp.asarray(p), jnp.asarray(x0), alpha, int(t_steps), eps)
    return np.asarray(x), int(t_steps), float(kl0), float(klt)


@functools.partial(jax.jit, static_argnames=("max_steps", "min_steps"))
def _adaptive(p, x0, alpha, kl_threshold, max_steps: int, min_steps: int, eps):
    kl0 = _kl_jit(p, x0, eps)

    def cond(state):
        x, t, klv = state
        return jnp.logical_and(
            t < max_steps,
            jnp.logical_or(t < min_steps, klv > kl_threshold),
        )

    def body(state):
        x, t, _ = state
        x = (1.0 - alpha) * x + alpha * p
        return x, t + 1, _kl_jit(p, x, eps)

    x, t, klv = jax.lax.while_loop(cond, body, (x0, jnp.int32(0), kl0))
    return x, t, kl0, klv


def gi_flow_to_threshold(
    p, x0, alpha: float, kl_threshold: float, max_steps: int, min_steps: int = 1,
    eps: float = 1e-12, host_numpy: bool = False,
):
    """Returns (X_T, T, kl0, klT) — gi_assumption_tracker_v3.py:137-148.

    host_numpy: same rationale as gi_flow_fixed_t, but the adaptive loop
    evaluates KL per step (O(T·bins²) logs) — callers should use it only
    for small grids (the tracker picks it for bins ≤ 128, exactly the
    stages that overlap its background eigensweeps)."""
    # the reference's `for t in range(1, max_steps+1)` body always runs at
    # least one mixture step before the t >= min_steps check, so
    # min_steps=0 must still advance X once (:137-148)
    min_steps = max(1, int(min_steps))
    if host_numpy:
        from cmtci.transport.histogram import kl as _kl_np

        p = np.asarray(p)
        x = np.asarray(x0)
        kl0 = _kl_np(p, x, eps)
        t, klv = 0, kl0
        while t < int(max_steps) and (t < int(min_steps) or klv > kl_threshold):
            x = (1.0 - alpha) * x + alpha * p
            t += 1
            klv = _kl_np(p, x, eps)
        return x, int(t), float(kl0), float(klv)

    x, t, kl0, klv = _adaptive(
        jnp.asarray(p), jnp.asarray(x0), alpha, kl_threshold, int(max_steps), int(min_steps), eps
    )
    return np.asarray(x), int(t), float(kl0), float(klv)


def tci_flow(p, x0, alpha: float, t_steps: int, eps: float = 1e-12):
    """KL trajectory variant (tci_construct_mandelbrot_v002_fixed.py:90-95).

    Returns (kls array of length T+1, trajectory list incl. X_0).
    """
    p = jnp.asarray(p)
    x = jnp.asarray(x0)
    kls = [kl(p, x, eps)]
    traj = [np.asarray(x)]
    for _ in range(int(t_steps)):
        x = (1.0 - alpha) * x + alpha * p
        kls.append(kl(p, x, eps))
        traj.append(np.asarray(x))
    return np.asarray(kls), traj
