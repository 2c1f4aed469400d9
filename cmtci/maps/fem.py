"""P1 FEM Laplace solver, harmonic conjugate, and θ-iteration (S1-S4).

Reference behavior (reimplemented, vectorized):
  * barycentric gradients + stiffness assembly (Python triangle loop into
    lil_matrix in the reference) — lucas_to_cardioid_v18...py:315-346
  * Dirichlet solve with arclength boundary data — :365-404
  * harmonic conjugate via weak form ∇v ≈ J∇u — :407-431
  * θ-iteration with circle normalization, periodic smoothing, unwrap, and
    2π-mismatch redistribution — :649-761

Assembly is one vectorized scatter (COO) instead of the per-triangle Python
loop; solves go through scipy spsolve (host, exact) or Jacobi-preconditioned
CG in jax (matvec via segment-sum over triangles).

NOTE — reference behavior, intentionally fixed: v18:725 builds
`theta_map = dict(zip(bnd_ord, theta))` and never uses it; every iteration
re-imposes u = cos(arclength θ), so the reference's θ never feeds back into
the Dirichlet data (the iteration is a no-op on u, v). Here the iterated θ
IS imposed per boundary node (`feedback=True`, the clear intent);
`feedback=False` reproduces the reference's dead-loop behavior.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve

from cmtci.geometry.mesh import boundary_vertices


def p1_grads_areas(points: np.ndarray, triangles: np.ndarray):
    """Barycentric basis gradients (nT,3,2) and areas (nT,), vectorized."""
    p0 = points[triangles[:, 0]]
    p1 = points[triangles[:, 1]]
    p2 = points[triangles[:, 2]]
    b00 = p1[:, 0] - p0[:, 0]
    b01 = p2[:, 0] - p0[:, 0]
    b10 = p1[:, 1] - p0[:, 1]
    b11 = p2[:, 1] - p0[:, 1]
    det = b00 * b11 - b01 * b10
    area = 0.5 * np.abs(det)
    inv_det = np.where(np.abs(det) < 1e-300, 0.0, 1.0 / np.where(det == 0, 1.0, det))
    # invB = [[b11,-b01],[-b10,b00]]/det; grads g1 = invB^T e1, g2 = invB^T e2
    g1 = np.column_stack([b11 * inv_det, -b01 * inv_det])
    g2 = np.column_stack([-b10 * inv_det, b00 * inv_det])
    g0 = -g1 - g2
    return np.stack([g0, g1, g2], axis=1), area


def assemble_stiffness(points: np.ndarray, triangles: np.ndarray, min_area: float = 1e-14):
    """Sparse CSR stiffness matrix; degenerate triangles skipped (v18:331-346)."""
    grads, area = p1_grads_areas(points, triangles)
    ok = area >= min_area
    grads, area, tris = grads[ok], area[ok], triangles[ok]
    ke = area[:, None, None] * np.einsum("tad,tbd->tab", grads, grads)
    rows = np.repeat(tris, 3, axis=1).reshape(-1)          # (nT*9,) a-index
    cols = np.tile(tris, (1, 3)).reshape(-1)               # (nT*9,) b-index
    k = sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(len(points),) * 2)
    return k.tocsr()


def dirichlet_solve(k: sp.csr_matrix, bnd: np.ndarray, g_bnd: np.ndarray, method: str = "spsolve"):
    """Dirichlet solve by symmetric elimination: K_ff u_f = -K_fb g.

    NOTE — reference bug, not reproduced: v18:378-404 moves the boundary
    terms of each free row into the RHS but also KEEPS the boundary columns
    in those rows; with the boundary identity rows this doubles the boundary
    coupling, so the reference's interior solution is 2x the harmonic
    extension (verified numerically). The elimination form below is the
    correct discrete harmonic extension and keeps K_ff symmetric positive
    definite for the CG path.
    """
    n = k.shape[0]
    free = np.ones(n, dtype=bool)
    free[bnd] = False
    k_ff = k[free][:, free]
    rhs_f = -(k[free][:, bnd] @ np.asarray(g_bnd))
    u = np.zeros(n)
    u[bnd] = g_bnd
    if method == "cg":
        u[free] = _cg_solve(k_ff.tocsr(), rhs_f)
    elif method == "device":
        from cmtci.maps.fem_device import DeviceSPDSolver

        u[free] = DeviceSPDSolver(k_ff).solve(rhs_f)
    else:
        u[free] = spsolve(k_ff.tocsr(), rhs_f)
    return u


def _cg_solve(a: sp.csr_matrix, rhs: np.ndarray, tol: float = 1e-12, maxiter: int = 20000):
    """Jacobi-preconditioned CG in jax on the BCOO matrix.

    (A device BCOO matvec was measured net-negative — gather-bound; see
    VALIDATION.md.)
    """
    from jax.experimental import sparse as jsparse


    coo = a.tocoo()
    mat = jsparse.BCOO(
        (jnp.asarray(coo.data), jnp.asarray(np.column_stack([coo.row, coo.col]))),
        shape=a.shape)
    diag = jnp.asarray(a.diagonal())
    minv = jnp.where(diag != 0, 1.0 / diag, 1.0)
    b = jnp.asarray(rhs)

    def matvec(x):
        return mat @ x

    x, _ = jax.scipy.sparse.linalg.cg(matvec, b, tol=tol, maxiter=maxiter,
                                      M=lambda r: minv * r)
    return np.asarray(x)


def _conjugate_rhs(triangles, grads, area, u, n: int) -> np.ndarray:
    """Weak-form RHS for ∇v ≈ J∇u: per-triangle area·(J∇u·∇λ_a), assembled
    over ALL triangles (the stiffness filter only drops degenerates)."""
    grad_u = np.einsum("ta,tad->td", np.asarray(u)[triangles], grads)  # (nT,2)
    ju = np.column_stack([-grad_u[:, 1], grad_u[:, 0]])
    contrib = area[:, None] * np.einsum("td,tad->ta", ju, grads)  # (nT,3)
    return np.bincount(triangles.reshape(-1), weights=contrib.reshape(-1),
                       minlength=n)


def harmonic_conjugate(points, triangles, u, pin: int = 0, method: str = "spsolve"):
    """Solve ∇v ≈ J∇u in weak form, pin one node (v18:407-431), vectorized RHS."""
    grads, area = p1_grads_areas(points, triangles)
    rhs = _conjugate_rhs(triangles, grads, area, u, len(points))
    k = assemble_stiffness(points, triangles)
    # pin one node to 0 by symmetric elimination (keeps SPD for CG)
    n = len(points)
    free = np.ones(n, dtype=bool)
    free[pin] = False
    k_ff = k[free][:, free].tocsr()
    rhs_f = rhs[free]
    v = np.zeros(n)
    if method == "cg":
        v[free] = _cg_solve(k_ff, rhs_f)
    elif method == "device":
        # NOT DeviceSPDSolver on the pinned k_ff: the weak single-node pin
        # leaves κ≈2e15 on sliver-bearing meshes and its f32 Cholesky is
        # not positive-definite (silent NaNs). The Neumann solver condenses
        # the sliver nodes and lifts the constant mode instead.
        from cmtci.maps.fem_device import DeviceNeumannSolver

        return DeviceNeumannSolver(k, pin=pin).solve(rhs)
    else:
        v[free] = spsolve(k_ff, rhs_f)
    return v


# --- boundary utilities (v18:641-694) --------------------------------------


def boundary_order_by_arclength(points, triangles, poly):
    bnd = boundary_vertices(triangles)
    s_b = poly.project(points[bnd])
    order = np.argsort(s_b)
    return bnd[order], s_b[order], poly.length


def moving_average_periodic(x, w: int, winding: float = 0.0):
    """Periodic moving average (v18:649-661).

    winding: amount by which the sequence increases over one period (pass
    2*pi for an unwrapped angle so the wrapped-around copies are continued
    rather than jumped).
    """
    if w <= 1:
        return np.asarray(x)
    w = int(w)
    if w % 2 == 0:
        w += 1
    pad = w // 2
    x = np.asarray(x)
    x_ext = np.concatenate([x[-pad:] - winding, x, x[:pad] + winding])
    return np.convolve(x_ext, np.ones(w) / w, mode="valid")[: len(x)]


def unwrap_theta(theta, anchor_index: int = 0):
    """np.unwrap shifted by a 2π multiple so theta[anchor_index] is kept.

    (np.unwrap is shift-invariant, so the former `unwrap(theta-th0)+th0`
    form anchored index 0 regardless of anchor_index.)
    """
    theta = np.asarray(theta, float)
    u = np.unwrap(theta)
    off = u[anchor_index] - theta[anchor_index]
    return u - 2.0 * np.pi * np.round(off / (2.0 * np.pi))


def circle_normalize_boundary(wb):
    """(center, radius, normalized) with mean center / median radius (v18:674-684)."""
    c = np.mean(wb)
    r = np.median(np.abs(wb - c))
    if not np.isfinite(r) or r < 1e-12:
        r = np.mean(np.abs(wb - c)) + 1e-12
    return c, r, (wb - c) / r


def optimal_rotation(w_src, w_tgt):
    """e^{iα} minimizing ||e^{iα} w_src − w_tgt|| (v18:687-694)."""
    num = np.sum(w_tgt * np.conj(w_src))
    if abs(num) < 1e-14:
        return 1.0 + 0.0j
    return num / abs(num)


def theta_iteration(
    points, triangles, poly,
    iters: int = 6, relax: float = 0.7, smooth: int = 7,
    unwrap_anchor: int = 0, periodic_enforce: bool = True,
    feedback: bool = True, method: str = "spsolve", verbose: bool = False,
    bnd_data=None,
):
    """Disk uniformization by FEM θ-iteration (v18:701-761).

    Returns (u, v, center, radius, period_mismatch) with (u+iv) normalized by
    the final boundary circle fit. `bnd_data` optionally supplies a
    precomputed boundary_order_by_arclength(points, triangles, poly) result.

    The iteration solves the SAME two linear systems every pass — the
    Dirichlet K_ff (boundary set is fixed) and the pinned conjugate K_ff —
    so both are LU-factorized once and the iters+1 passes reuse the
    factors (the reference re-runs spsolve per pass, v18:726-727; 7
    SuperLU factorizations per system collapse to 1).

    method="device" runs the WHOLE iteration on the accelerator as one
    fused dispatch (dense Cholesky solves; see maps/fem_device.py).
    """
    if method == "device":
        from cmtci.maps.fem_device import theta_iteration_device

        return theta_iteration_device(
            points, triangles, poly, iters=iters, relax=relax, smooth=smooth,
            unwrap_anchor=unwrap_anchor, periodic_enforce=periodic_enforce,
            feedback=feedback, verbose=verbose, bnd_data=bnd_data)
    bnd_ord, s_b, big_l = (bnd_data if bnd_data is not None
                           else boundary_order_by_arclength(points, triangles, poly))
    theta = -np.pi + 2.0 * np.pi * (s_b / big_l)
    t_param = s_b / big_l
    k = assemble_stiffness(points, triangles)
    grads, area = p1_grads_areas(points, triangles)
    n = len(points)
    period_mis = np.nan

    free_d = np.ones(n, dtype=bool)
    free_d[bnd_ord] = False
    k_fb_d = k[free_d][:, bnd_ord].tocsr()
    k_ff_d = k[free_d][:, free_d].tocsr()
    free_c = np.ones(n, dtype=bool)
    free_c[0] = False  # pin=0
    k_ff_c = k[free_c][:, free_c].tocsr()
    if method == "cg":
        solve_d = lambda b: _cg_solve(k_ff_d, b)  # noqa: E731
        solve_c = lambda b: _cg_solve(k_ff_c, b)  # noqa: E731
    else:
        solve_d = sp.linalg.splu(k_ff_d.tocsc()).solve
        solve_c = sp.linalg.splu(k_ff_c.tocsc()).solve

    def solve_uv(th_bnd):
        g = np.cos(th_bnd)
        u = np.zeros(n)
        u[bnd_ord] = g
        u[free_d] = solve_d(-(k_fb_d @ g))
        rhs = _conjugate_rhs(triangles, grads, area, u, n)
        v = np.zeros(n)
        v[free_c] = solve_c(rhs[free_c])
        return u, v

    for it in range(1, iters + 1):
        th_data = theta if feedback else (-np.pi + 2.0 * np.pi * (s_b / big_l))
        u, v = solve_uv(th_data)
        wb = u[bnd_ord] + 1j * v[bnd_ord]
        _, _, wb_norm = circle_normalize_boundary(wb)
        theta_new = np.angle(wb_norm)
        if feedback:
            # unwrap BEFORE smoothing: the reference smooths the wrapped
            # angle (v18:736-737), which corrupts the ±pi jump at the anchor;
            # harmless there only because its θ never feeds back.
            theta_new = unwrap_theta(theta_new, anchor_index=unwrap_anchor)
            span = theta_new[-1] - theta_new[0]
            wind = 2.0 * np.pi * np.round(span / (2.0 * np.pi) + 0.1 * np.sign(span))
            theta_new = moving_average_periodic(theta_new, smooth, winding=wind)
        else:
            theta_new = moving_average_periodic(theta_new, smooth)
            theta_new = unwrap_theta(theta_new, anchor_index=unwrap_anchor)
        if periodic_enforce:
            theta_new = theta_new - theta_new[0]
            period_mis = (theta_new[-1] - theta_new[0]) - 2.0 * np.pi
            theta_new = theta_new - period_mis * t_param
        if verbose:  # true iterate movement — measured BEFORE the relaxation
            drift = float(np.median(np.abs(theta_new - theta)))
            print(f"    [theta-iter] k={it}/{iters} median drift {drift:.6f} rad")
        theta = (1.0 - relax) * theta + relax * theta_new

    u, v = solve_uv(theta if feedback else (-np.pi + 2.0 * np.pi * (s_b / big_l)))
    wb = u[bnd_ord] + 1j * v[bnd_ord]
    c_last, r_last, _ = circle_normalize_boundary(wb)
    w = (u + 1j * v - c_last) / r_last
    return w.real, w.imag, c_last, r_last, float(period_mis)
