"""Device-native FEM θ-iteration (S2-S4 on the accelerator).

The reference solves the Laplace Dirichlet problem and the harmonic
conjugate with scipy `spsolve` per θ-iteration pass
(lucas_to_cardioid_v18_periodic_theta_crbins_artifacts.py:726-727, assembly
:331-346). The host rebuild (cmtci.maps.fem) already collapses the repeated
factorizations to one SuperLU factor pair — this module moves the WHOLE
iteration onto the device as a single fused XLA dispatch per mesh:

  * the operators (Dirichlet K_ff, Dirichlet K_fb, the FULL Neumann K for
    the conjugate) are shipped as COO triplets (a few MB) and scattered
    into dense on-device — never transfer an O(n²) dense matrix from the
    host;
  * both SPD blocks are symmetrically equilibrated (D^-1/2 K D^-1/2; the
    Lucas alpha-shape meshes carry slim boundary triangles whose stiffness
    diagonal spans ~1e11, κ(K_ff)≈3e13 raw vs ≈7e2 equilibrated) and
    Cholesky-factorized ONCE; every pass is two triangular solves + the
    weak-form conjugate RHS as a segment-sum over triangles;
  * the conjugate is solved as the statically-condensed, rank-one-lifted
    full Neumann system instead of the host's drop-one-row pin. The Lucas
    alpha-shape meshes carry a handful of sliver vertices whose stiffness
    diagonal is ~1e11: the raw pinned system has κ≈2e15 (the weak
    single-node pin), equilibration alone still leaves sliver-localized
    modes at λ≈1e-11 whose f32 Cholesky is not positive-definite — yet
    those modes carry the slivers' REAL O(1) boundary values (they are
    weakly-coupled DOFs, not noise), so they cannot be regularized away.
    The fix is structural: the host Schur-eliminates the high-diagonal
    sliver nodes in f64 (a |s|≈10 dense block), ships the reduced
    equilibrated operator (κ≈3e3 after the constant-mode lift ŵŵᵀ,
    f32-friendly) plus the back-substitution couplings W = K_ss⁻¹K_sr,
    and the device recovers v_s = K_ss⁻¹b_s − W v_r per pass — an O(1)
    interpolation map that is benign in f32. The result is then shifted
    so v[pin]=0; it matches the host pinned solve to the ~1e-4
    conditioning floor (the spread between ANY two backward-stable f64
    solvers on the κ≈2e15 pinned system);
  * the θ machinery (circle normalization with a median radius, anchored
    unwrap, periodic moving average, 2π-mismatch redistribution,
    relaxation) runs in jnp between the solves, so the 6-pass iteration
    plus the final solve is ONE jit call — one dispatch instead of 14+
    host↔device solves.

dtype policy (utils/device): float64 path is exact (used on CPU meshes and
in the parity tests — agrees with the SuperLU path to ~1e-12); on a GPU
session the factorization runs float32 (whether f64 on the card should
replace it is open) and `final_host_solve=True` (the default there)
re-solves the final pass on the host in f64 with the converged θ, so the
returned u/v — and the CR-defect/Beltrami diagnostics computed from them —
carry full f64 solve accuracy; only the θ trajectory itself is f32
(observed ~1e-5 vs f64, VALIDATION.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from cmtci.utils.device import on_gpu


def _coo_parts(m: sp.spmatrix, dtype):
    c = m.tocoo()
    return (jnp.asarray(c.row.astype(np.int32)),
            jnp.asarray(c.col.astype(np.int32)),
            jnp.asarray(c.data.astype(dtype)))


def _dense_from_coo(rows, cols, vals, shape, dtype):
    return jnp.zeros(shape, dtype).at[rows, cols].add(vals)


def _unwrap_anchored(theta, anchor: int):
    """jnp version of fem.unwrap_theta (np.unwrap + 2π re-anchoring)."""
    u = jnp.unwrap(theta)
    off = u[anchor] - theta[anchor]
    return u - 2.0 * jnp.pi * jnp.round(off / (2.0 * jnp.pi))


def _moving_avg_periodic(x, w: int, winding):
    """jnp version of fem.moving_average_periodic (w static, odd).

    Unrolled shifted-slice sum, NOT jnp.convolve: a backend may lower the
    conv at reduced precision (bf16 or TF32), whose ~1e-2 error per pass
    the θ feedback amplifies to O(1)."""
    if w <= 1:
        return x
    pad = w // 2
    x_ext = jnp.concatenate([x[-pad:] - winding, x, x[:pad] + winding])
    n = x.shape[0]
    acc = x_ext[:n]
    for i in range(1, w):
        acc = acc + x_ext[i : i + n]
    return acc / x.dtype.type(w)


def _circle_normalize(ub, vb):
    """jnp version of fem.circle_normalize_boundary (mean center, median
    radius with the degenerate-radius fallback, v18:674-684)."""
    cu = jnp.mean(ub)
    cv = jnp.mean(vb)
    r_abs = jnp.hypot(ub - cu, vb - cv)
    r = jnp.median(r_abs)
    r = jnp.where(jnp.isfinite(r) & (r >= 1e-12), r, jnp.mean(r_abs) + 1e-12)
    return cu, cv, r


@functools.partial(
    jax.jit,
    static_argnames=("n", "iters", "relax", "smooth", "anchor", "pin",
                     "feedback", "periodic_enforce"),
)
def _theta_core(
    ffd, fbd, sred,           # each: (rows, cols, vals) COO triplets
    d_d, d_s, w_hat,          # equilibration scalings + lifted null vector
    kss_inv, w_bs,            # sliver condensation: K_ss⁻¹, W = K_ss⁻¹K_sr
    r_idx, s_idx,             # non-sliver / sliver node indices
    tris, grads, area,        # conjugate weak-form data
    t_param,                  # s_b / L, arclength parameter in [0,1)
    bnd_idx, free_d_idx,
    *, n: int, iters: int, relax: float, smooth: int, anchor: int,
    pin: int, feedback: bool, periodic_enforce: bool,
):
    dtype = area.dtype
    nf_d = free_d_idx.shape[0]
    nb = bnd_idx.shape[0]
    nr = r_idx.shape[0]
    # ffd/sred arrive pre-equilibrated (vals already D^-1/2 · D^-1/2);
    # sred is the Schur-condensed Neumann operator on the r (non-sliver)
    # nodes, w_hat its equilibrated constant null vector, kss_inv/w_bs the
    # f64-host-prepared |s|-block inverse and couplings W = K_ss⁻¹K_sr.
    kd = _dense_from_coo(*ffd, (nf_d, nf_d), dtype)
    kb = _dense_from_coo(*fbd, (nf_d, nb), dtype)
    kc = (_dense_from_coo(*sred, (nr, nr), dtype)
          + w_hat[:, None] * w_hat[None, :])
    lc = jnp.linalg.cholesky(kc)
    ld = jnp.linalg.cholesky(kd)
    two_pi = dtype.type(2.0 * np.pi)
    pi = dtype.type(np.pi)

    chol_solve = _chol_solve  # shared two-triangular-solve helper

    def solve_conj(rhs):
        b_s = rhs[s_idx]
        b_r = rhs[r_idx] - w_bs.T @ b_s
        v_r = d_s * chol_solve(lc, d_s * b_r)
        v_s = kss_inv @ b_s - w_bs @ v_r
        v0 = jnp.zeros((n,), dtype).at[r_idx].set(v_r).at[s_idx].set(v_s)
        return v0 - v0[pin]

    def solve_uv(th_bnd):
        g = jnp.cos(th_bnd)
        uf = d_d * chol_solve(ld, -d_d * (kb @ g))
        u = jnp.zeros((n,), dtype).at[bnd_idx].set(g).at[free_d_idx].set(uf)
        gu = jnp.einsum("ta,tad->td", u[tris], grads)
        ju = jnp.stack([-gu[:, 1], gu[:, 0]], axis=-1)
        contrib = area[:, None] * jnp.einsum("td,tad->ta", ju, grads)
        rhs = jax.ops.segment_sum(contrib.reshape(-1), tris.reshape(-1),
                                  num_segments=n)
        return u, solve_conj(rhs)

    theta0 = -pi + two_pi * t_param
    theta = theta0
    period_mis = dtype.type(np.nan)
    drifts = []
    for _ in range(iters):
        u, v = solve_uv(theta if feedback else theta0)
        cu, cv, r = _circle_normalize(u[bnd_idx], v[bnd_idx])
        theta_new = jnp.arctan2((v[bnd_idx] - cv) / r, (u[bnd_idx] - cu) / r)
        if feedback:
            theta_new = _unwrap_anchored(theta_new, anchor)
            span = theta_new[-1] - theta_new[0]
            wind = two_pi * jnp.round(span / two_pi
                                      + dtype.type(0.1) * jnp.sign(span))
            theta_new = _moving_avg_periodic(theta_new, smooth, wind)
        else:
            theta_new = _moving_avg_periodic(theta_new, smooth, dtype.type(0))
            theta_new = _unwrap_anchored(theta_new, anchor)
        if periodic_enforce:
            theta_new = theta_new - theta_new[0]
            period_mis = (theta_new[-1] - theta_new[0]) - two_pi
            theta_new = theta_new - period_mis * t_param
        drifts.append(jnp.median(jnp.abs(theta_new - theta)))
        theta = (dtype.type(1.0 - relax) * theta
                 + dtype.type(relax) * theta_new)

    u, v = solve_uv(theta if feedback else theta0)
    cu, cv, r = _circle_normalize(u[bnd_idx], v[bnd_idx])
    # pack EVERYTHING into one vector: every fetched array is a blocking
    # device→host copy, so (uv | scalars | theta | drifts) ride one async
    # host copy per mesh (ThetaHandle.prefetch overlaps them all)
    uv = jnp.stack([(u - cu) / r, (v - cv) / r])
    scalars = jnp.stack([cu, cv, r, period_mis])
    return jnp.concatenate([
        uv.reshape(-1), scalars, theta,
        jnp.stack(drifts) if drifts else jnp.zeros((0,), dtype)])


def _reduced_systems(k: sp.csr_matrix, bnd_ord: np.ndarray, pin: int = 0):
    """Host extraction of the three reduced operators (cheap CSR slicing)."""
    n = k.shape[0]
    free_d = np.ones(n, dtype=bool)
    free_d[bnd_ord] = False
    free_c = np.ones(n, dtype=bool)
    free_c[pin] = False
    return (k[free_d][:, free_d], k[free_d][:, bnd_ord], k[free_c][:, free_c],
            np.where(free_d)[0], np.where(free_c)[0])


def _equilibrated_coo(m: sp.spmatrix, dtype):
    """(COO triplets of D^-1/2 M D^-1/2, d = 1/sqrt(diag M)) — scaling in
    f64 on the host so the shipped f32 triplets carry no extra roundoff."""
    c = m.tocoo()
    d = 1.0 / np.sqrt(c.tocsr().diagonal())
    vals = c.data * d[c.row] * d[c.col]
    return (jnp.asarray(c.row.astype(np.int32)),
            jnp.asarray(c.col.astype(np.int32)),
            jnp.asarray(vals.astype(dtype))), d


def _condense_slivers(k: sp.csr_matrix, diag_factor: float = 1e6):
    """Static condensation of the sliver vertices out of the Neumann K.

    Sliver nodes — diag(K) > diag_factor·median(diag(K)), from slim
    alpha-shape boundary triangles — are the source of the λ≈1e-11
    equilibrated modes that break an f32 factorization. Eliminating them
    exactly (f64 host Schur complement over a ~10-node dense block) leaves
    a reduced Neumann operator whose equilibrated+lifted κ is ~3e3.

    Returns (r_idx, s_idx, S, kss_inv, W) with S = K_rr − K_rs K_ss⁻¹ K_sr
    (sparse — W inherits K_sr's column sparsity) and W = K_ss⁻¹ K_sr.
    """
    dg = k.diagonal()
    s_mask = dg > diag_factor * np.median(dg)
    s_idx = np.where(s_mask)[0]
    r_idx = np.where(~s_mask)[0]
    if len(s_idx) == 0:
        return r_idx, s_idx, k, np.zeros((0, 0)), sp.csr_matrix((0, k.shape[0]))
    kss_inv = np.linalg.inv(k[s_idx][:, s_idx].toarray())
    k_sr = k[s_idx][:, r_idx].tocsr()
    w = sp.csr_matrix(kss_inv) @ k_sr
    s_red = (k[r_idx][:, r_idx] - k[r_idx][:, s_idx] @ w).tocsr()
    return r_idx, s_idx, s_red, kss_inv, w


class ThetaHandle:
    """Async handle for a dispatched device θ-iteration.

    The dispatch is non-blocking (jax async execution) and the whole
    output rides ONE packed vector: a pipeline can dispatch every level's
    iteration, `prefetch()` them all (async device→host copies overlap
    across meshes instead of blocking one by one), then `.result()` each.
    result() performs the final host
    f64 solve at the converged θ for f32 runs, reusing the prep cache's
    SuperLU factors.
    """

    def __init__(self, out, ctx):
        self._out = out
        self._ctx = ctx

    def prefetch(self):
        try:
            self._out.copy_to_host_async()
        except AttributeError:  # non-jax array (already host)
            pass
        return self

    def result(self):
        from cmtci.maps import fem

        c = self._ctx
        n, nb, iters = c["n"], len(c["bnd_ord"]), c["iters"]
        packed = np.asarray(self._out, dtype=np.float64)
        uv = packed[: 2 * n].reshape(2, n)
        scalars = packed[2 * n : 2 * n + 4]
        theta_h = packed[2 * n + 4 : 2 * n + 4 + nb]
        if c["verbose"]:
            drifts = packed[2 * n + 4 + nb :]
            for i, d in enumerate(drifts, start=1):
                print(f"    [theta-iter/device] k={i}/{iters} median "
                      f"drift {float(d):.6f} rad")
        if c["final_host_solve"]:
            period_mis = float(scalars[3])
            bnd_ord, s_b, big_l = c["bnd_ord"], c["s_b"], c["big_l"]
            prep = c["prep"]
            triangles, grads, area = (prep["triangles_np"], prep["grads_np"],
                                      prep["area_np"])
            th0 = -np.pi + 2.0 * np.pi * (s_b / big_l)
            solve_d, solve_c = prep["splu_d"], prep["splu_c"]
            g = np.cos(theta_h if c["feedback"] else th0)
            u = np.zeros(n)
            u[bnd_ord] = g
            u[prep["free_d_idx_np"]] = solve_d(-(prep["k_fb_np"] @ g))
            rhs = fem._conjugate_rhs(triangles, grads, area, u, n)
            v = np.zeros(n)
            v[prep["free_c_idx_np"]] = solve_c(rhs[prep["free_c_idx_np"]])
            wb = u[bnd_ord] + 1j * v[bnd_ord]
            c_last, r_last, _ = fem.circle_normalize_boundary(wb)
            w = (u + 1j * v - c_last) / r_last
            return w.real, w.imag, c_last, r_last, period_mis
        return (uv[0], uv[1], complex(scalars[0], scalars[1]),
                float(scalars[2]), float(scalars[3]))


_PREP_CACHE: dict = {}
_PREP_CACHE_MAX = 24


def _mesh_prep(points, triangles, bnd_ord, dtype, need_splu: bool):
    """Device-resident per-mesh dispatch state, memoized.

    Everything that depends only on (mesh, boundary order, dtype) — the
    equilibrated COO triplets ON DEVICE, the condensation couplings, the
    index arrays, and (lazily) the SuperLU factors for the final f64 host
    solve. The device_puts and the two splu factorizations are paid once
    per mesh by a parameter sweep or repeated run. Bounded FIFO cache.
    """
    import hashlib

    from cmtci.maps import fem

    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(points))
    h.update(np.ascontiguousarray(triangles))
    h.update(np.ascontiguousarray(bnd_ord))
    key = (h.hexdigest(), str(dtype))
    prep = _PREP_CACHE.get(key)
    if prep is None:
        k = fem.assemble_stiffness(points, triangles)
        grads, area = fem.p1_grads_areas(points, triangles)
        kffd, kfbd, kffc, free_d_idx, free_c_idx = _reduced_systems(k, bnd_ord)
        ffd_eq, d_d = _equilibrated_coo(kffd, dtype)
        r_idx, s_idx, s_red, kss_inv, w_cpl = _condense_slivers(k)
        sred_eq, d_s = _equilibrated_coo(s_red, dtype)
        w = 1.0 / d_s  # D^{1/2}·1_r — the reduced Neumann null vector
        w_hat = w / np.linalg.norm(w)
        n = len(points)
        free_d = np.ones(n, dtype=bool)
        free_d[bnd_ord] = False
        prep = dict(
            ffd_eq=ffd_eq, fbd=_coo_parts(kfbd, dtype), sred_eq=sred_eq,
            d_d=jnp.asarray(d_d.astype(dtype)),
            d_s=jnp.asarray(d_s.astype(dtype)),
            w_hat=jnp.asarray(w_hat.astype(dtype)),
            kss_inv=jnp.asarray(kss_inv.astype(dtype)),
            w_bs=jnp.asarray(w_cpl.toarray().astype(dtype)),
            r_idx=jnp.asarray(r_idx.astype(np.int32)),
            s_idx=jnp.asarray(s_idx.astype(np.int32)),
            tris=jnp.asarray(triangles.astype(np.int32)),
            grads=jnp.asarray(grads.astype(dtype)),
            area=jnp.asarray(area.astype(dtype)),
            bnd_idx=jnp.asarray(bnd_ord.astype(np.int32)),
            free_d_idx=jnp.asarray(free_d_idx.astype(np.int32)),
            triangles_np=triangles, grads_np=grads, area_np=area,
            kffd=kffd, kffc=kffc, k_fb_np=k[free_d][:, bnd_ord].tocsr(),
            free_d_idx_np=free_d_idx, free_c_idx_np=free_c_idx,
            splu_d=None, splu_c=None,
        )
        if len(_PREP_CACHE) >= _PREP_CACHE_MAX:
            _PREP_CACHE.pop(next(iter(_PREP_CACHE)))
        _PREP_CACHE[key] = prep
    if need_splu and prep["splu_d"] is None:
        prep["splu_d"] = sp.linalg.splu(prep["kffd"].tocsc()).solve
        prep["splu_c"] = sp.linalg.splu(prep["kffc"].tocsc()).solve
    return prep


def dispatch_theta_iteration_device(
    points, triangles, poly,
    iters: int = 6, relax: float = 0.7, smooth: int = 7,
    unwrap_anchor: int = 0, periodic_enforce: bool = True,
    feedback: bool = True, verbose: bool = False,
    bnd_data=None, dtype=None, final_host_solve: bool | None = None,
) -> ThetaHandle:
    """Dispatch the fused θ-iteration to the device; returns a ThetaHandle.

    dtype=None resolves to float32 on a GPU session, float64 otherwise.
    final_host_solve (default: True exactly when the device ran f32)
    re-solves the final pass on the host with SuperLU in f64 at the
    device-converged θ, so downstream CR/Beltrami diagnostics see full
    solve precision regardless of the accelerator dtype. Matmuls trace at
    precision=HIGHEST — the GPU's TF32 default loses ~3 digits of the θ
    trajectory. The dispatch-static per-mesh state (equilibrated
    operators on device, condensation couplings, SuperLU factors) is
    memoized in _PREP_CACHE, so warm repeats ship only the jit call.
    """
    from cmtci.maps import fem

    bnd_ord, s_b, big_l = (bnd_data if bnd_data is not None
                           else fem.boundary_order_by_arclength(
                               points, triangles, poly))
    if dtype is None:
        dtype = jnp.float32 if on_gpu() else jnp.float64
    dtype = jnp.dtype(dtype)
    if final_host_solve is None:
        final_host_solve = dtype == jnp.float32

    smooth = int(smooth)
    if smooth > 1 and smooth % 2 == 0:
        smooth += 1  # host moving_average_periodic widens even windows

    n = len(points)
    prep = _mesh_prep(points, triangles, bnd_ord, dtype,
                      need_splu=final_host_solve)
    with jax.default_matmul_precision("highest"):
        out = _theta_core(
            prep["ffd_eq"], prep["fbd"], prep["sred_eq"],
            prep["d_d"], prep["d_s"], prep["w_hat"],
            prep["kss_inv"], prep["w_bs"], prep["r_idx"], prep["s_idx"],
            prep["tris"], prep["grads"], prep["area"],
            jnp.asarray((s_b / big_l).astype(dtype)),
            prep["bnd_idx"], prep["free_d_idx"],
            n=n, iters=int(iters), relax=float(relax), smooth=smooth,
            anchor=int(unwrap_anchor), pin=0, feedback=bool(feedback),
            periodic_enforce=bool(periodic_enforce),
        )
    ctx = dict(verbose=verbose, final_host_solve=final_host_solve,
               feedback=feedback, n=n, iters=int(iters), bnd_ord=bnd_ord,
               s_b=s_b, big_l=big_l, prep=prep)
    return ThetaHandle(out, ctx)


def theta_iteration_device(points, triangles, poly, **kw):
    """Drop-in device twin of fem.theta_iteration (same returns)."""
    return dispatch_theta_iteration_device(points, triangles, poly,
                                           **kw).result()


class DeviceSPDSolver:
    """Dense Cholesky solver on the device for a (reduced) SPD FEM matrix.

    The standalone-solve twin of the fused θ-iteration path: ships the
    matrix as COO, factorizes once on device, and solves right-hand sides
    with two triangular solves per call. `refine` steps of classical
    iterative refinement compute the residual on the host in f64 against
    the exact sparse operator — on an f32 accelerator this recovers ~4
    digits per step until the f32 correction-solve floor (~κ·ε32).
    Reference solves: lucas_to_cardioid_v18...py:726-727 (spsolve).
    """

    def __init__(self, k_ff: sp.spmatrix, dtype=None):
        if dtype is None:
            dtype = jnp.float32 if on_gpu() else jnp.float64
        self.dtype = jnp.dtype(dtype)
        self.k = k_ff.tocsr()
        (rows, cols, vals), self._d = _equilibrated_coo(self.k, self.dtype)
        nf = self.k.shape[0]
        with jax.default_matmul_precision("highest"):
            self._l = _spd_factor(rows, cols, vals, nf)

    def _apply(self, b64: np.ndarray) -> np.ndarray:
        y = _chol_solve_jit(self._l, jnp.asarray(
            (self._d * b64).astype(self.dtype)))
        return self._d * np.asarray(y, np.float64)

    def solve(self, b: np.ndarray, refine: int = 2) -> np.ndarray:
        b64 = np.asarray(b, np.float64)
        with jax.default_matmul_precision("highest"):
            x = self._apply(b64)
            for _ in range(refine):
                x = x + self._apply(b64 - self.k @ x)
        return x


class DeviceNeumannSolver:
    """Pinned Neumann solve (harmonic-conjugate class) on the device.

    The standalone twin of the fused θ-iteration's conjugate path: the
    weakly-pinned reduced system has κ≈2e15 on sliver-bearing meshes and
    its f32 Cholesky is not positive-definite, so this solver takes the
    FULL singular Neumann K, Schur-condenses the high-diagonal sliver
    nodes on the host in f64 (_condense_slivers), equilibrates + lifts
    the constant null mode, factorizes on device, back-substitutes the
    sliver values, and shifts so v[pin]=0. Classical refinement is OFF by
    default: unlike the SPD case, the pin-shifted lifted apply is not a
    contraction for x += apply(b − Kx) on a near-singular K (measured
    divergent on a synthetic sliver system), and the direct solve already
    sits at the lifted-vs-pinned distribution floor (~1e-6 relative at
    the solution scale) in BOTH dtypes.
    Reference: lucas_to_cardioid_v18...py:407-431.
    """

    def __init__(self, k: sp.spmatrix, pin: int = 0, dtype=None):
        if dtype is None:
            dtype = jnp.float32 if on_gpu() else jnp.float64
        self.dtype = jnp.dtype(dtype)
        self.k = k.tocsr()
        self.pin = pin
        self._r_idx, self._s_idx, s_red, self._kss_inv, w_cpl = (
            _condense_slivers(self.k))
        self._w_bs = w_cpl.toarray()
        (rows, cols, vals), self._d = _equilibrated_coo(s_red, self.dtype)
        w = 1.0 / self._d
        w_hat = jnp.asarray((w / np.linalg.norm(w)).astype(self.dtype))
        nr = s_red.shape[0]
        with jax.default_matmul_precision("highest"):
            self._l = _spd_factor_lifted(rows, cols, vals, w_hat, nr)

    def _apply(self, b64: np.ndarray) -> np.ndarray:
        b_s = b64[self._s_idx]
        b_r = b64[self._r_idx] - self._w_bs.T @ b_s
        y = _chol_solve_jit(self._l, jnp.asarray(
            (self._d * b_r).astype(self.dtype)))
        v_r = self._d * np.asarray(y, np.float64)
        v_s = self._kss_inv @ b_s - self._w_bs @ v_r
        v = np.zeros(len(b64))
        v[self._r_idx] = v_r
        v[self._s_idx] = v_s
        return v - v[self.pin]

    def solve(self, rhs: np.ndarray, refine: int = 0) -> np.ndarray:
        b64 = np.asarray(rhs, np.float64)
        with jax.default_matmul_precision("highest"):
            x = self._apply(b64)
            for _ in range(refine):
                x = x + self._apply(b64 - self.k @ x)
        return x


@functools.partial(jax.jit, static_argnames=("nf",))
def _spd_factor(rows, cols, vals, nf: int):
    return jnp.linalg.cholesky(_dense_from_coo(rows, cols, vals,
                                               (nf, nf), vals.dtype))


@functools.partial(jax.jit, static_argnames=("nf",))
def _spd_factor_lifted(rows, cols, vals, w_hat, nf: int):
    kc = (_dense_from_coo(rows, cols, vals, (nf, nf), vals.dtype)
          + w_hat[:, None] * w_hat[None, :])
    return jnp.linalg.cholesky(kc)


def _chol_solve(l_fac, b):
    """x with L Lᵀ x = b via two triangular solves (traced in callers)."""
    y = jax.lax.linalg.triangular_solve(l_fac, b[:, None],
                                        left_side=True, lower=True)
    return jax.lax.linalg.triangular_solve(
        l_fac, y, left_side=True, lower=True, transpose_a=True)[:, 0]


_chol_solve_jit = jax.jit(_chol_solve)
