"""Boundary-integral (Nyström) Riemann map with Green-function modulus (S5).

Reference: lucas_to_cardioid_v40_reference.py:184-360 —
  g(z) = -log|z-a| + ∫ σ(ζ) log|z-ζ| ds + C (+ g_shift), |f| = exp(-g),
  phase from Im of the path integral of Φ'(z) = -1/(z-a) + Σ σ_j ds_j/(z-ζ_j)
  along [a + ε·dir, z] with 16-node Gauss–Legendre; (σ, C) from a dense
  least-squares fit with log kernel, diagonal surrogate log(ds/2)-1,
  constraint ∫σ ds = 0, ridge 1e-8, robust median recompute of C, and a
  g_shift calibration so median g(boundary-in) = 0.

Device-first: the reference evaluates Φ_raw with a per-point Python loop
(20000 × (16×2000) kernel evals — its hottest path); here it is one blocked
batched quadrature (einsum-shaped elementwise reductions over (chunk,16,N)),
and g_real is a blocked log-kernel matvec. Complex values use (re, im)
float64 pairs. The one-time dense lstsq stays on host LAPACK.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from cmtci.geometry.polygon import Polygon, ensure_interior_point, slightly_inside
from cmtci.geometry.resample import sample_polygon_boundary
from cmtci.utils.device import highest_precision

PATH_GAUSS_N = 16
EPS_POLE = 1e-6
DZ_EPS = 1e-14
EXP_CLIP = 60.0
RIDGE_LAMBDA = 1e-8


def gauss_legendre_01(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def safe_exp_minus_real(g):
    return np.exp(np.clip(-np.asarray(g, dtype=float), -EXP_CLIP, EXP_CLIP))


@functools.partial(jax.jit, static_argnames=("chunk",))
@highest_precision
def _g_real_blocked(zr, zi, br, bi, sigw, ar, ai, c_plus_shift, chunk: int = 600):
    """g(z) = -log|z-a| + Σ_j sigw_j log|z-ζ_j| + C + shift, blocked over z."""
    m = zr.shape[0]
    mp = ((m + chunk - 1) // chunk) * chunk
    zrp = jnp.pad(zr, (0, mp - m))
    zip_ = jnp.pad(zi, (0, mp - m))

    def body(i, out):
        zzr = jax.lax.dynamic_slice_in_dim(zrp, i * chunk, chunk)
        zzi = jax.lax.dynamic_slice_in_dim(zip_, i * chunk, chunk)
        dr = zzr[:, None] - br[None, :]
        di = zzi[:, None] - bi[None, :]
        logabs = jnp.log(jnp.hypot(dr, di) + 1e-300)
        sl = logabs @ sigw
        da = jnp.hypot(zzr - ar, zzi - ai)
        val = -jnp.log(da + 1e-300) + sl + c_plus_shift
        return jax.lax.dynamic_update_slice_in_dim(out, val, i * chunk, axis=0)

    out = jnp.zeros(mp, dtype=zr.dtype)
    return jax.lax.fori_loop(0, mp // chunk, body, out)[:m]


@functools.partial(jax.jit, static_argnames=("chunk",))
@highest_precision
def _phi_raw_blocked(zr, zi, br, bi, sigds, ar, ai, c_const, gx, gw, chunk: int = 512):
    """Path-integrated Φ at each z (v40:213-238), blocked over z.

    Returns (re, im). Quadrature nodes xi = z0 + gx*seg with z0 = a + ε·dir.
    """
    m = zr.shape[0]
    mp = ((m + chunk - 1) // chunk) * chunk
    zrp = jnp.pad(zr, (0, mp - m))
    zip_ = jnp.pad(zi, (0, mp - m), constant_values=1.0)

    def dphi(xr, xi_):
        """Φ'(x) for x of shape (B,G): -1/(x-a) + Σ_j sigds_j/(x-ζ_j)."""
        d0r = xr - ar
        d0i = xi_ - ai
        small0 = jnp.hypot(d0r, d0i) < DZ_EPS
        d0r = jnp.where(small0, DZ_EPS, d0r)
        d0i = jnp.where(small0, 0.0, d0i)
        den0 = d0r * d0r + d0i * d0i
        # -1/(x-a)
        out_r = -d0r / den0
        out_i = d0i / den0
        # + Σ_j sigds_j / (x - ζ_j), reduced over j in one shot
        dr = xr[..., None] - br
        di = xi_[..., None] - bi
        small = jnp.hypot(dr, di) < DZ_EPS
        dr = jnp.where(small, DZ_EPS, dr)
        di = jnp.where(small, 0.0, di)
        den = dr * dr + di * di
        out_r = out_r + jnp.sum(sigds * dr / den, axis=-1)
        out_i = out_i + jnp.sum(sigds * (-di) / den, axis=-1)
        return out_r, out_i

    def body(i, outs):
        or_, oi_ = outs
        zzr = jax.lax.dynamic_slice_in_dim(zrp, i * chunk, chunk)
        zzi = jax.lax.dynamic_slice_in_dim(zip_, i * chunk, chunk)
        dzr = zzr - ar
        dzi = zzi - ai
        dabs = jnp.hypot(dzr, dzi)
        dirr = dzr / jnp.maximum(dabs, 1e-300)
        diri = dzi / jnp.maximum(dabs, 1e-300)
        z0r = ar + EPS_POLE * dirr
        z0i = ai + EPS_POLE * diri
        segr = zzr - z0r
        segi = zzi - z0i
        xr = z0r[:, None] + gx[None, :] * segr[:, None]
        xi_ = z0i[:, None] + gx[None, :] * segi[:, None]
        dp_r, dp_i = dphi(xr, xi_)
        # integral = Σ_k w_k * dphi_k * seg
        ir = (dp_r @ gw) * segr - (dp_i @ gw) * segi
        ii = (dp_r @ gw) * segi + (dp_i @ gw) * segr
        # real anchor: -log(EPS_POLE) + Σ sigds log|z0-ζ| + C
        lr = jnp.log(jnp.hypot(z0r[:, None] - br, z0i[:, None] - bi) + 1e-300)
        phi0 = -math.log(EPS_POLE) + lr @ sigds + c_const
        ir = ir + phi0
        or_ = jax.lax.dynamic_update_slice_in_dim(or_, ir, i * chunk, axis=0)
        oi_ = jax.lax.dynamic_update_slice_in_dim(oi_, ii, i * chunk, axis=0)
        return or_, oi_

    init = (jnp.zeros(mp, dtype=zr.dtype), jnp.zeros(mp, dtype=zr.dtype))
    or_, oi_ = jax.lax.fori_loop(0, mp // chunk, body, init)
    return or_[:m], oi_[:m]


@jax.jit
@highest_precision
def _g_phi_fused(gzr, gzi, pzr, pzi, br, bi, sigw, sigds, ar, ai,
                 c_plus_shift, c_const, gx, gw):
    """g_real on (gzr,gzi) + Φ_raw on (pzr,pzi) in ONE compiled call.

    The pipeline evaluates g on interior+boundary-in points and Φ on the
    interior points; fusing them halves the dispatches and fetches."""
    g = _g_real_blocked(gzr, gzi, br, bi, sigw, ar, ai, c_plus_shift)
    pre, pim = _phi_raw_blocked(pzr, pzi, br, bi, sigds, ar, ai, c_const, gx, gw)
    return g, pre, pim


@dataclass
class RiemannMapGreenModulus:
    """Fitted Lucas-domain -> unit-disk Riemann map (v40 semantics)."""

    bdy_z: np.ndarray  # complex (N,)
    ds: np.ndarray
    sigma: np.ndarray
    a: complex
    c: float
    g_shift: float = 0.0
    gauss_n: int = PATH_GAUSS_N
    _gx: np.ndarray = field(default=None, repr=False)
    _gw: np.ndarray = field(default=None, repr=False)
    _kds: np.ndarray = field(default=None, repr=False)  # fit-time log kernel,
    # cached so boundary_residual doesn't re-assemble the N×N host matrix

    def __post_init__(self):
        self._gx, self._gw = gauss_legendre_01(self.gauss_n)

    # dtype=None -> f64 (parity).
    # dtype=jnp.float32 -> the device fast path; error budget: Im Phi mod 2pi
    # (the quantity f consumes) p99 ~1e-5 rad, g abs err <= 1e-4. Re Phi
    # carries a winding-count (2pi-multiple) offset in f32 that cancels in
    # f = exp(-g - i Im Phi).
    def _args(self, dtype=None):
        dt = dtype or jnp.float64
        return (
            jnp.asarray(self.bdy_z.real, dt), jnp.asarray(self.bdy_z.imag, dt),
            jnp.asarray(self.sigma * self.ds, dt),
            np.dtype(np.float32 if dtype == jnp.float32 else np.float64).type(self.a.real),
            np.dtype(np.float32 if dtype == jnp.float32 else np.float64).type(self.a.imag),
        )

    def g_real(self, z, dtype=None):
        z = np.asarray(z, dtype=complex).ravel()
        br, bi, sigds, ar, ai = self._args(dtype)
        dt = dtype or jnp.float64
        out = _g_real_blocked(jnp.asarray(z.real, dt), jnp.asarray(z.imag, dt),
                              br, bi, sigds, ar, ai,
                              np.asarray(self.c + self.g_shift, dt))
        return np.asarray(out, np.float64)

    def phi_raw(self, z, dtype=None):
        z = np.asarray(z, dtype=complex).ravel()
        br, bi, sigds, ar, ai = self._args(dtype)
        dt = dtype or jnp.float64
        re, im = _phi_raw_blocked(jnp.asarray(z.real, dt), jnp.asarray(z.imag, dt),
                                  br, bi, sigds, ar, ai, np.asarray(self.c, dt),
                                  jnp.asarray(self._gx, dt), jnp.asarray(self._gw, dt))
        return (np.asarray(re, np.float64)
                + 1j * np.asarray(im, np.float64))

    def phi(self, z, dtype=None):
        """Composite Φ: Re from g_real, Im from phi_raw (v40:259-264)."""
        return self.g_real(z, dtype) + 1j * self.phi_raw(z, dtype).imag

    def eval_g_phi(self, z_g, z_phi, dtype=None):
        """(g(z_g), Im Φ_raw(z_phi)) in one device call (see _g_phi_fused)."""
        z_g = np.asarray(z_g, dtype=complex).ravel()
        z_phi = np.asarray(z_phi, dtype=complex).ravel()
        br, bi, sigds, ar, ai = self._args(dtype)
        dt = dtype or jnp.float64
        g, _, pim = _g_phi_fused(
            jnp.asarray(z_g.real, dt), jnp.asarray(z_g.imag, dt),
            jnp.asarray(z_phi.real, dt), jnp.asarray(z_phi.imag, dt),
            br, bi, sigds, sigds, ar, ai,
            np.asarray(self.c + self.g_shift, dt), np.asarray(self.c, dt),
            jnp.asarray(self._gx, dt), jnp.asarray(self._gw, dt))
        return np.asarray(g, np.float64), np.asarray(pim, np.float64)

    def f(self, z, dtype=None):
        """f(z) = exp(-g) · exp(-i Im Φ_raw) (v40:266-272)."""
        g = self.g_real(z, dtype)
        im = self.phi_raw(z, dtype).imag
        return safe_exp_minus_real(g) * np.exp(-1j * im)

    def boundary_residual(self):
        """Fit residual on boundary nodes (v40:347,592-599)."""
        if self._kds is None:
            # memoized: a map reconstructed from a cached/serialized fit
            # state arrives without the N×N kernel, and re-assembling it on
            # every diagnostics call was ~0.1 s at N=2000
            self._kds = _log_kernel_ds(self.bdy_z, self.ds)
        return (self._kds @ self.sigma) + self.c - np.log(np.abs(self.bdy_z - self.a) + 1e-300)


def _log_kernel_ds(z: np.ndarray, ds: np.ndarray):
    absd = np.abs(z[:, None] - z[None, :])
    k = np.log(absd + 1e-300)
    di = np.diag_indices_from(k)
    k[di] = np.log(np.maximum(ds, 1e-300) / 2.0) - 1.0
    return k * ds[None, :]


def _log_kernel_ds_fast(z: np.ndarray, ds: np.ndarray, workers: int = 4):
    """log|z_i-z_j| via 0.5·log(d²) — skips the hypot that dominates
    _log_kernel_ds (np.abs on complex). Differs from the exact form by
    ≤1 ulp per entry, far below the qr32 fit's refinement limit; the
    parity lstsq path keeps _log_kernel_ds.

    Row-blocked across a small thread pool: the N² f64 log was the qr32
    fit's largest single host cost (~0.09 s at N=2000), and numpy's big
    ufuncs release the GIL, so 4 workers cut it ~3x. Each row's values are
    computed by the identical expressions in the identical order —
    bitwise-equal to the single-thread result."""
    x, y = z.real, z.imag
    n = len(z)
    k = np.empty((n, n))
    dsw = ds[None, :]

    def _rows(lo, hi):
        d2 = ((x[lo:hi, None] - x[None, :]) ** 2
              + (y[lo:hi, None] - y[None, :]) ** 2)
        np.multiply(0.5 * np.log(d2 + 1e-300), dsw, out=k[lo:hi])

    if workers > 1 and n >= 512:
        from concurrent.futures import ThreadPoolExecutor

        step = (n + workers - 1) // workers
        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(lambda lo: _rows(lo, min(lo + step, n)),
                        range(0, n, step)))
    else:
        _rows(0, n)
    di = np.diag_indices_from(k)
    k[di] = (np.log(np.maximum(ds, 1e-300) / 2.0) - 1.0) * ds
    return k


@functools.partial(jax.jit, static_argnames=("n",))
@highest_precision
def _qr_r_device(zr, zi, ds, ar, ai, n: int, ridge):
    """R factor + direct solve of the column-equilibrated v40 fit, f32.

    Stacked system (v40:300-321): N log-kernel rows [kds | 1], one
    constraint row [ds | 0], N ridge rows sqrt(ridge)·[I | 0]; columns
    scaled by 1/cn, with cn (the column norms) computed device-side so the
    call needs NOTHING from the host f64 kernel assembly — jax dispatch is
    async, so the host assembles its f64 kds for the refinement residuals
    WHILE the device runs the QR. QR(mode='r') on the default device — the
    2·(2N+1)·N² flops that were the host-f64 fit's dominant cost land on
    the device — and the x0 corrected-semi-normal direct solve is fused in.
    Returns (R, cn, x0).
    """
    dr = zr[:, None] - zr[None, :]
    di_ = zi[:, None] - zi[None, :]
    absd = jnp.sqrt(dr * dr + di_ * di_)
    eye = jnp.eye(n, dtype=zr.dtype)
    k = jnp.where(eye > 0,
                  jnp.log(jnp.maximum(ds, 1e-30) / 2.0)[None, :] - 1.0,
                  jnp.log(absd + 1e-30))
    kds = k * ds[None, :]
    cn = jnp.concatenate([
        jnp.sqrt(jnp.sum(kds * kds, axis=0) + ds * ds + ridge),
        jnp.sqrt(jnp.asarray(n, zr.dtype))[None],
    ])
    a_top = jnp.concatenate([kds, jnp.ones((n, 1), zr.dtype)], axis=1)
    a_con = jnp.concatenate([ds, jnp.zeros((1,), zr.dtype)])[None, :]
    a_reg = jnp.concatenate(
        [jnp.sqrt(ridge) * eye, jnp.zeros((n, 1), zr.dtype)], axis=1)
    a0 = jnp.concatenate([a_top, a_con, a_reg], axis=0) / cn[None, :]
    r_mat = jnp.linalg.qr(a0, mode="r")
    b = jnp.log(jnp.hypot(zr - ar, zi - ai) + 1e-30)
    atb = jnp.concatenate([kds.T @ b, jnp.sum(b)[None]]) / cn
    x0 = _seminormal_solve_device(r_mat, atb) / cn
    return r_mat, cn, x0


@jax.jit
def _seminormal_solve_device(r_mat, atr_scaled):
    """x̂ = R⁻¹ R⁻ᵀ (Aᵀr/cn) — corrected-semi-normal step (device, f32)."""
    y = jax.scipy.linalg.solve_triangular(r_mat, atr_scaled, trans=1, lower=False)
    return jax.scipy.linalg.solve_triangular(r_mat, y, trans=0, lower=False)


@jax.jit
def _seminormal_solve_scaled(r_mat, cn, atr):
    """Semi-normal step with the device-resident column scaling."""
    return _seminormal_solve_device(r_mat, atr / cn) / cn


def _fit_sigma_qr32(z, ds, b, a, ridge, refine: int = 2):
    """Device-f32 QR + host-f64 iterative refinement for the v40 fit.

    The preconditioner (QR of the f32 column-equilibrated stacked matrix)
    lives on the device and the direct solve is fused into the same
    roundtrip; each refinement round the host computes the FULL f64
    residual of the stacked system (O(N²) matvecs against the
    already-assembled f64 kds) and only (N+1)-vectors cross the
    host↔device link. Measured at n_bdy=2000: max|σ−σ_lstsq| = 1.9e-7
    after 2 refinement rounds — two orders below the 7.6e-5
    boundary-residual budget (VALIDATION.md); the all-f32 variant stalls
    at 2e-4, which is why the residuals are f64.
    """
    n = len(z)
    sridge = math.sqrt(ridge)
    with jax.enable_x64(False):
        f32 = jnp.float32
        # async dispatch: the device starts the f32 assembly+QR while the
        # host builds the f64 log kernel the refinement residuals need
        r_mat, cn_dev, x0 = _qr_r_device(
            jnp.asarray(z.real, f32), jnp.asarray(z.imag, f32),
            jnp.asarray(ds, f32), np.float32(a.real), np.float32(a.imag),
            n, np.float32(ridge))
        kds = _log_kernel_ds_fast(z, ds)
        x = np.asarray(x0, dtype=np.float64)
        for _ in range(refine):
            r_top = b - (kds @ x[:n] + x[n])
            atr = (kds.T @ r_top + ds * (-(ds @ x[:n]))
                   + sridge * (-sridge * x[:n]))
            atr = np.append(atr, r_top.sum())
            dx = np.asarray(_seminormal_solve_scaled(
                r_mat, cn_dev, jnp.asarray(atr, f32)), dtype=np.float64)
            x = x + dx
    return x, kds


def fit_riemann_map(poly: Polygon, n_bdy: int = 2000, a: complex | None = None,
                    ridge: float = RIDGE_LAMBDA, inward_eps: float = 1e-3,
                    gauss_n: int = PATH_GAUSS_N, verbose: bool = False,
                    solver: str = "lstsq", calibrate_g_shift: bool = True):
    """Fit (σ, C, g_shift) — lucas_to_cardioid_v40_reference.py:278-360.

    solver="lstsq" is the reference's np.linalg.lstsq (SVD — the parity
    default); "normal" solves the ridge-regularized normal equations by
    Cholesky on the host, ~8x faster at n_bdy=2000 with σ agreeing to
    1.4e-8; "qr32" runs the dense factorization on the default DEVICE in
    f32 (column-equilibrated QR + corrected-semi-normal solves) with f64
    host-residual refinement — σ to 1.9e-7 of lstsq, and the only host
    flops left are O(N²) matvecs (the f32 pipeline's default).
    """
    z, ds = sample_polygon_boundary(poly, n_bdy)
    if a is None:
        a = poly.centroid
    a = ensure_interior_point(poly, a)
    n = len(z)

    b = np.log(np.abs(z - a) + 1e-300)

    if solver == "qr32":
        # kds is assembled inside (host f64, overlapped with the device QR)
        x, kds = _fit_sigma_qr32(z, ds, b, a, ridge)
    elif solver in ("normal", "lstsq"):
        kds = _log_kernel_ds(z, ds)
        a_mat = np.zeros((n, n + 1))
        a_mat[:, :n] = kds
        a_mat[:, n] = 1.0
        a_con = np.zeros((1, n + 1))
        a_con[0, :n] = ds
        a0 = np.vstack([a_mat, a_con])
        b0 = np.concatenate([b, [0.0]])
        if ridge > 0:
            a_reg = np.zeros((n, n + 1))
            a_reg[:, :n] = math.sqrt(ridge) * np.eye(n)
            a0 = np.vstack([a0, a_reg])
            b0 = np.concatenate([b0, np.zeros(n)])
        if solver == "normal":
            import scipy.linalg as _sla

            x = _sla.solve(a0.T @ a0, a0.T @ b0, assume_a="pos")
        else:
            x, *_ = np.linalg.lstsq(a0, b0, rcond=None)
    else:
        raise ValueError(f"unknown solver '{solver}'")
    sigma = x[:n]
    # robust median recompute of C (v40:328)
    c = float(np.median(np.log(np.abs(z - a) + 1e-300) - (kds @ sigma)))

    rm = RiemannMapGreenModulus(bdy_z=z, ds=ds, sigma=sigma, a=a, c=c, gauss_n=gauss_n)
    rm._kds = kds
    if not calibrate_g_shift:
        # caller derives g_shift from its own g(boundary-in) evaluation
        # (the uniformize-green pipeline's fused device call evaluates the
        # same inward-shifted nodes anyway — the host N×N d2 block below
        # was ~0.06 s of pure duplication); rm.g_shift stays 0.0
        return rm
    z_in = slightly_inside(z, a, inward_eps)
    if solver == "qr32":
        # g_shift calibration with the direct host log-kernel (0.5·log d²
        # form, no diagonal: z_in is strictly inside) — the generic
        # rm.g_real roundtrip was the fit's single largest cost
        d2 = ((z_in.real[:, None] - z.real[None, :]) ** 2
              + (z_in.imag[:, None] - z.imag[None, :]) ** 2)
        g_in = (-np.log(np.abs(z_in - a) + 1e-300)
                + (0.5 * np.log(d2 + 1e-300)) @ (sigma * ds) + c)
        rm.g_shift = -float(np.median(g_in))
    else:
        rm.g_shift = -float(np.median(rm.g_real(z_in)))

    if verbose:
        mod = np.abs(rm.f(z_in))
        r = rm.boundary_residual()
        print(f"[riemann] a={a:.6f} |f(bdy-in)| median={np.median(mod):.9f} "
              f"p90={np.quantile(mod, 0.9):.9f}")
        print(f"[riemann] bdy-resid median={np.median(r):+.3e} "
              f"maxabs={np.max(np.abs(r)):.3e}")
    return rm
