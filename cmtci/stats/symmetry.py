"""Symmetry analysis: discrete ops + best reflection-axis search (T17).

Reference: symmetry_phase_bestaxis.py:36-296 — ops {identity, reflect_x,
reflect_y, rot_pi, reflect about an arbitrary axis through the centroid};
preservation fraction = share of points whose symmetric image has a nearest
neighbor within TOL; 361-angle coarse scan then bounded scalar refinement.
(The reference file as checked in has a SyntaxError at :181 — `bounds=`
passed twice to minimize_scalar; the clear intent, a bounded refine within
±5° of the coarse optimum, is implemented here.)

Device-first: the nearest-neighbor distances are a blocked min-distance kernel
and the 361-angle scan vmaps over angles.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


from cmtci.utils.arrays import as_xy as _xy  # shared (N,2) coercion


def reflect_across_line(points, angle: float, origin=None):
    """Reflect about the line through `origin` at `angle` (radians).

    Matches symmetry_phase_bestaxis.py:51-77 (rotate by -angle, flip y,
    rotate back).
    """
    points = _xy(points)
    if origin is None:
        origin = points.mean(axis=0)
    p = points - origin
    c, s = math.cos(angle), math.sin(angle)
    # rotate by -angle, reflect y -> -y, rotate by +angle == reflection matrix
    refl = np.array([[c * c - s * s, 2 * s * c], [2 * s * c, s * s - c * c]])
    return p @ refl.T + origin


def apply_symmetry_op(points, op: str, angle: float | None = None):
    """symmetry_phase_bestaxis.py:79-93 semantics."""
    p = _xy(points).copy()
    if op == "identity":
        return p
    if op == "reflect_x":
        p[:, 1] = -p[:, 1]
        return p
    if op == "reflect_y":
        p[:, 0] = -p[:, 0]
        return p
    if op == "rot_pi":
        return -p
    if op == "reflect_angle":
        if angle is None:
            raise ValueError("angle must be provided for reflect_angle")
        return reflect_across_line(p, angle, origin=p.mean(axis=0))
    raise ValueError(f"Unknown op {op}")


@functools.partial(jax.jit, static_argnames=("chunk",))
def nearest_distances(a, b, chunk: int = 1024):
    """min_j |a_i - b_j| for each i (blocked)."""
    n = a.shape[0]
    npad = ((n + chunk - 1) // chunk) * chunk
    ap = jnp.pad(a, ((0, npad - n), (0, 0)))

    def body(i, out):
        blk = jax.lax.dynamic_slice_in_dim(ap, i * chunk, chunk, axis=0)
        d2 = jnp.sum((blk[:, None, :] - b[None, :, :]) ** 2, axis=-1)
        return jax.lax.dynamic_update_slice_in_dim(out, jnp.sqrt(jnp.min(d2, axis=1)), i * chunk, axis=0)

    out = jnp.zeros(npad, dtype=a.dtype)
    out = jax.lax.fori_loop(0, npad // chunk, body, out)
    return out[:n]


@functools.partial(jax.jit, static_argnames=("chunk",))
def _nearest_distances_ops(qs, p, chunk: int = 1024):
    """nearest_distances for a stack of op images (O, N, 2) vs one cloud."""
    return jax.lax.map(lambda q: nearest_distances(q, p, chunk=chunk), qs)


def preservation_fractions(points, ops, tol: float = 0.05, dtype=None):
    """preservation_fraction batched over ops: ONE device dispatch + fetch
    per cloud instead of len(ops) sequential dispatches (the op table was
    8 dispatches per symmetry report). Values identical to
    the per-op calls (same kernel, same dtype policy). Returns
    (fracs list, distances (len(ops), N))."""
    from cmtci.utils.device import analysis_dtype_ctx

    p = _xy(points)
    qs = np.stack([apply_symmetry_op(p, op) for op in ops])
    dt, x64_ctx = analysis_dtype_ctx(dtype)
    with x64_ctx:
        d = np.asarray(_nearest_distances_ops(jnp.asarray(qs, dtype=dt),
                                              jnp.asarray(p, dtype=dt)),
                       dtype=np.float64)
    return [float((di <= tol).mean()) for di in d], d


def preservation_fraction(points, op: str, tol: float = 0.05, angle: float | None = None,
                          dtype=None):
    """Fraction of points whose op-image is within tol of some point.

    dtype=jnp.float32 runs the blocked NN scan on the default device (same
    tolerance argument as _score_angles: ~1e-7-relative distance noise vs
    a 0.05 tol shell); the op image itself is computed exactly in host f64
    either way. f64 (default or explicit) runs at the ambient
    precision (analysis_dtype_ctx — the shared device policy)."""
    from cmtci.utils.device import analysis_dtype_ctx

    p = _xy(points)
    q = apply_symmetry_op(p, op, angle)
    dt, x64_ctx = analysis_dtype_ctx(dtype)
    with x64_ctx:
        d = np.asarray(nearest_distances(jnp.asarray(q, dtype=dt),
                                         jnp.asarray(p, dtype=dt)),
                       dtype=np.float64)
    return float((d <= tol).mean()), d


@jax.jit
def _reflect_batch(p, angles, origin):
    """Reflect p (N,2) about lines through origin at each angle -> (A,N,2)."""
    q = p - origin
    c2 = jnp.cos(2.0 * angles)[:, None]
    s2 = jnp.sin(2.0 * angles)[:, None]
    x, y = q[:, 0][None, :], q[:, 1][None, :]
    xr = c2 * x + s2 * y
    yr = s2 * x - c2 * y
    return jnp.stack([xr, yr], axis=-1) + origin


def _score_angles(points, angles, tol: float, dtype=None):
    """Preserved fraction for each reflection angle (vmapped NN queries).

    dtype=jnp.float32 runs the scan on the default device — the NN
    distances carry ~1e-7 relative noise against a 0.05 tolerance, so
    fraction flips need a point sitting within f32 noise of the tol shell;
    f64 (default or explicit) runs on the default device too
    (analysis_dtype_ctx).
    """
    from cmtci.utils.device import analysis_dtype_ctx

    dt, x64_ctx = analysis_dtype_ctx(dtype)
    with x64_ctx:
        p = jnp.asarray(_xy(points), dtype=dt)
        origin = p.mean(axis=0)
        refl = _reflect_batch(p, jnp.asarray(angles, dtype=p.dtype), origin)

        def frac(q):
            d = nearest_distances(q, p)
            return jnp.mean((d <= p.dtype.type(tol)).astype(p.dtype))

        return np.asarray(jax.lax.map(frac, refl), dtype=np.float64)


def best_reflection_axis(points_a, points_b, tol: float = 0.05, n_angles: int = 361,
                         refine: bool = True, mesh=None, dtype=None):
    """Coarse 0..pi scan + bounded refine of the joint preservation score.

    Returns dict(angle, frac_a, frac_b, scan_angles, scan_score).
    Score = frac_a + frac_b, maximized (symmetry_phase_bestaxis.py:153-199).
    dtype=jnp.float32 runs the scans on the default device.
    """
    angles = np.linspace(0, np.pi, n_angles)
    if mesh is not None and dtype is not None:
        raise ValueError(
            "best_reflection_axis: mesh and dtype are mutually exclusive — "
            "the sharded scan is the f64 multi-device path; the f32 device "
            "scan is single-device (drop one of them). Mixing them would "
            "pick the angle at f64 but report f32 fractions.")
    if mesh is not None:
        # angle-sharded coarse scan (parallel.sharded.sharded_score_angles,
        # bitwise-identical: per-angle scores are independent)
        from cmtci.parallel.sharded import sharded_score_angles

        fa = sharded_score_angles(points_a, angles, tol, mesh)
        fb = sharded_score_angles(points_b, angles, tol, mesh)
    else:
        fa = _score_angles(points_a, angles, tol, dtype=dtype)
        fb = _score_angles(points_b, angles, tol, dtype=dtype)
    score = fa + fb
    best = float(angles[np.argmax(score)])

    if refine and dtype is not None:
        # device path: two batched grid stages instead of scipy's ~25
        # SEQUENTIAL scalar evaluations (each a dispatch and a fetch).
        # Stage 1
        # scans 128 angles over the same ±π/36 window; stage 2 scans 128
        # around its peak: final resolution ≈ 2.2e-5 rad, finer than the
        # host path's xatol=1e-4. A grid argmax of the same objective the
        # scipy path optimizes — an equivalent-accuracy realization.
        half = math.pi / 36
        best_sc = float(score[np.argmax(score)])
        for _ in range(2):
            lo = max(0.0, best - half)
            hi = min(math.pi, best + half)
            grid = np.linspace(lo, hi, 128)
            sc = (_score_angles(points_a, grid, tol, dtype=dtype)
                  + _score_angles(points_b, grid, tol, dtype=dtype))
            k = int(np.argmax(sc))
            if sc[k] >= best_sc:  # the incumbent is not ON the new grid —
                best, best_sc = float(grid[k]), float(sc[k])  # never regress
            half = grid[1] - grid[0]
    elif refine:
        from scipy.optimize import minimize_scalar

        def neg(a):
            sa = _score_angles(points_a, np.array([a]), tol, dtype=dtype)[0]
            sb = _score_angles(points_b, np.array([a]), tol, dtype=dtype)[0]
            return -(sa + sb)

        lo = max(0.0, best - math.pi / 36)
        hi = min(math.pi, best + math.pi / 36)
        res = minimize_scalar(neg, bounds=(lo, hi), method="bounded",
                              options={"xatol": 1e-4})
        if res.success:
            best = float(res.x)

    # the final fractions ride the same dtype/device as the scan that picked
    # the angle (consistent precision per report; under f32 this also drops
    # the last two O(n²) f64 host scans — the stage wall at 5k+ buses)
    frac_a, _ = preservation_fraction(points_a, "reflect_angle", tol, angle=best,
                                      dtype=dtype)
    frac_b, _ = preservation_fraction(points_b, "reflect_angle", tol, angle=best,
                                      dtype=dtype)
    return {"angle": best, "frac_a": frac_a, "frac_b": frac_b,
            "scan_angles": angles, "scan_score": score}


def symmetry_report(c_aligned, m_points, matches=None, tol: float = 0.05,
                    scan_dtype=None):
    """Full op table + best-axis row (symmetry_phase_bestaxis.py:118-211).

    scan_dtype=jnp.float32 runs the 361-angle best-axis scan AND the op
    table's 8 NN scans on the default device — the op table was
    "cheap" only at reference scale (8 × n² f64 host scans ≈ 4 s of the
    6 s stage at a 5k bus)."""
    rows = []
    c = _xy(c_aligned)
    m = _xy(m_points)
    ops = ("identity", "reflect_x", "reflect_y", "rot_pi")
    fcs, dcs = preservation_fractions(c, ops, tol, dtype=scan_dtype)
    fms, dms = preservation_fractions(m, ops, tol, dtype=scan_dtype)
    for op, fc, dc, fm, dm in zip(ops, fcs, dcs, fms, dms):
        row = {
            "op": op, "angle_deg": None,
            "preserved_construct_frac": fc, "preserved_mandel_frac": fm,
            "mean_distC": float(dc.mean()), "mean_distM": float(dm.mean()),
        }
        if matches is not None:
            c_op = apply_symmetry_op(c, op)
            m_op = apply_symmetry_op(m, op)[np.asarray(matches, dtype=int)]
            d_cross = np.linalg.norm(c_op - m_op, axis=1)
            row["cross_preserved_frac"] = float((d_cross <= tol).mean())
        rows.append(row)

    best = best_reflection_axis(c, m, tol, dtype=scan_dtype)
    row = {
        "op": "reflect_best_angle", "angle_deg": float(np.degrees(best["angle"])),
        "preserved_construct_frac": best["frac_a"],
        "preserved_mandel_frac": best["frac_b"],
    }
    if matches is not None:
        c_ref = reflect_across_line(c, best["angle"], origin=c.mean(axis=0))
        m_ref = reflect_across_line(m, best["angle"], origin=m.mean(axis=0))[np.asarray(matches, dtype=int)]
        row["cross_preserved_frac"] = float((np.linalg.norm(c_ref - m_ref, axis=1) <= tol).mean())
    rows.append(row)
    return rows, best
