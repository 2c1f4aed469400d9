"""Mandelbrot escape-time / distance-estimator / Green-function fields.

One family of batched, jittable iteration kernels covering every escape-loop
variant in the reference (reimplemented, not copied; complex numbers carried
as (re, im) float pairs so the same code runs on every backend):

  * dwell grid                 — mandelbrot_boundary_sample.py:22-39
  * DE, TCI variant            — tci_construct_mandelbrot_v002_fixed.py:35-47
      (dz NOT latched: it keeps iterating to IEEE overflow after escape, so
      d == 0 for all but the latest escapers; the 25%-quantile boundary
      sampler at :49-59 therefore selects the whole escaped exterior. We
      reproduce that faithfully — it is the oracle behavior behind the
      checked-in v3_*.csv artifacts.)
  * DE, standard variant       — variograms_construct_mandelbrot.py:61-88
      (latches z AND dz; num = log(max(|z|,1))*|z|, R=4)
  * parameter-plane Green g_M, Phi — lucas_equipotential_test_v3.py:124-162
  * escape potentials, 3 normalizations:
      log|z_n| / 2^n at first escape   — variograms_construct_mandelbrot.py:148-173
      log|z_k| / 2^k with break        — Potentials.py:32-47
      log|z_k| / (k+1)                 — Laplacian_C-M.py:27-43

These run the loop over the full array with escape latches (`jnp.where`),
which XLA fuses into a single elementwise pipeline; the Pallas kernel in
mandelbrot_pallas.py adds per-block early exit for GPU throughput.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np



def complex_grid(domain, nx: int, ny: int, dtype=jnp.float64):
    """(cr, ci) meshgrid matching np.meshgrid(xs, ys) indexing='xy'.

    domain = (xmin, xmax, ymin, ymax); output shape (ny, nx).
    """
    xmin, xmax, ymin, ymax = domain
    xs = jnp.linspace(xmin, xmax, nx, dtype=dtype)
    ys = jnp.linspace(ymin, ymax, ny, dtype=dtype)
    cr, ci = jnp.meshgrid(xs, ys, indexing="xy")
    return cr, ci


def _zsq_add_c(zr, zi, cr, ci):
    """z <- z*z + c, componentwise like numpy's complex multiply."""
    return zr * zr - zi * zi + cr, zr * zi + zi * zr + ci


@functools.partial(jax.jit, static_argnames=("max_iter",))
def dwell_grid(cr, ci, max_iter: int = 500):
    """Escape-time dwell counts (mandelbrot_boundary_sample.py:22-30).

    dwell = first n (0-based) with |z_{n+1}|^2 > 4, else max_iter.
    """
    zr = jnp.zeros_like(cr)
    zi = jnp.zeros_like(ci)
    dwell = jnp.full(cr.shape, max_iter, dtype=jnp.int32)
    esc = jnp.zeros(cr.shape, dtype=bool)

    def body(n, s):
        zr, zi, dwell, esc = s
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = (zr * zr + zi * zi > 4.0) & ~esc
        dwell = jnp.where(hit, n, dwell)
        esc = esc | hit
        # freeze escaped orbits so f32 runs don't generate inf/nan churn
        zr = jnp.where(esc, jnp.where(hit, zr, 0.0), zr)
        zi = jnp.where(esc, jnp.where(hit, zi, 0.0), zi)
        return zr, zi, dwell, esc

    _, _, dwell, _ = jax.lax.fori_loop(0, max_iter, body, (zr, zi, dwell, esc))
    return dwell


@functools.partial(jax.jit, static_argnames=("max_iter",))
def de_field_tci(cr, ci, max_iter: int = 250, escape_r: float = 250.0, eps: float = 1e-12):
    """TCI distance estimator (tci_construct_mandelbrot_v002_fixed.py:35-47).

    Exact reference semantics: dz is updated BEFORE z each step, z is latched
    at first |z| > escape_r, dz is NOT latched and overflows to inf for early
    escapers (so d == 0 there). Returns (esc, d, last_r, last_i).
    """
    zr = jnp.zeros_like(cr)
    zi = jnp.zeros_like(ci)
    dzr = jnp.ones_like(cr)
    dzi = jnp.zeros_like(ci)
    esc = jnp.zeros(cr.shape, dtype=bool)
    lr = jnp.zeros_like(cr)
    li = jnp.zeros_like(ci)

    def body(_, s):
        zr, zi, dzr, dzi, esc, lr, li = s
        # dz = 2*z*dz + 1 (numpy op order: t = 2*z, then t*dz, then +1)
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = (jnp.sqrt(zr * zr + zi * zi) > escape_r) & ~esc
        lr = jnp.where(hit, zr, lr)
        li = jnp.where(hit, zi, li)
        esc = esc | hit
        return zr, zi, dzr, dzi, esc, lr, li

    zr, zi, dzr, dzi, esc, lr, li = jax.lax.fori_loop(
        0, max_iter, body, (zr, zi, dzr, dzi, esc, lr, li)
    )
    az = jnp.hypot(lr, li)
    # 2*z*dz with the latched z and FINAL dz (possibly inf/nan); hypot matches
    # numpy's complex abs (no premature overflow at |.| ~ 1e200)
    pr, pi = 2.0 * lr * dzr - 2.0 * li * dzi, 2.0 * lr * dzi + 2.0 * li * dzr
    den = jnp.maximum(jnp.hypot(pr, pi), eps)
    d = jnp.where(esc, jnp.log(jnp.maximum(az, 1e-300)) * az / den, 0.0)
    d = jnp.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)
    return esc, d, lr, li


@functools.partial(jax.jit, static_argnames=("max_iter",))
def de_field_std(cr, ci, max_iter: int = 500, escape_r: float = 4.0, eps: float = 1e-14):
    """Standard distance estimator (variograms_construct_mandelbrot.py:61-88).

    Latches both z and dz at first escape; num = log(max(|z|,1))*|z|.
    Returns (esc, dist, last_z(re,im), last_dz(re,im)).
    """
    zr = jnp.zeros_like(cr)
    zi = jnp.zeros_like(ci)
    dzr = jnp.ones_like(cr)
    dzi = jnp.zeros_like(ci)
    esc = jnp.zeros(cr.shape, dtype=bool)
    lzr = jnp.zeros_like(cr)
    lzi = jnp.zeros_like(ci)
    ldr = jnp.ones_like(cr)
    ldi = jnp.zeros_like(ci)

    def body(_, s):
        zr, zi, dzr, dzi, esc, lzr, lzi, ldr, ldi = s
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = ~esc & (jnp.sqrt(zr * zr + zi * zi) > escape_r)
        lzr = jnp.where(hit, zr, lzr)
        lzi = jnp.where(hit, zi, lzi)
        ldr = jnp.where(hit, dzr, ldr)
        ldi = jnp.where(hit, dzi, ldi)
        esc = esc | hit
        # freeze escaped orbits (z/dz are latched; further evolution unused)
        zr = jnp.where(esc, 0.0, zr)
        zi = jnp.where(esc, 0.0, zi)
        dzr = jnp.where(esc, 1.0, dzr)
        dzi = jnp.where(esc, 0.0, dzi)
        return zr, zi, dzr, dzi, esc, lzr, lzi, ldr, ldi

    out = jax.lax.fori_loop(0, max_iter, body, (zr, zi, dzr, dzi, esc, lzr, lzi, ldr, ldi))
    zr, zi, dzr, dzi, esc, lzr, lzi, ldr, ldi = out
    az = jnp.hypot(lzr, lzi)
    pr, pi = 2.0 * (lzr * ldr - lzi * ldi), 2.0 * (lzr * ldi + lzi * ldr)
    num = jnp.log(jnp.maximum(az, 1.0)) * az
    den = jnp.maximum(jnp.hypot(pr, pi), eps)
    dist = jnp.where(esc, jnp.nan_to_num(num / den, nan=0.0, posinf=0.0, neginf=0.0), 0.0)
    return esc, dist, (lzr, lzi), (ldr, ldi)


@functools.partial(jax.jit, static_argnames=("iters",))
def _green_stage(zr, zi, cr, ci, k0, iters: int, r2, dtype_max_iter):
    """Run `iters` Green iterations from state (zr, zi) with k offset k0.

    Returns (zr, zi, esc, g, k, lpr, lpi) where non-escaping points carry
    k = dtype_max_iter and g = 0 (overwritten by later stages if they escape).
    """
    esc = jnp.zeros(cr.shape, dtype=bool)
    g = jnp.zeros_like(cr)
    kk = jnp.full(cr.shape, dtype_max_iter, dtype=jnp.int32)
    lpr = jnp.zeros_like(cr)
    lpi = jnp.zeros_like(ci)

    def body(i, s):
        zr, zi, esc, g, kk, lpr, lpi = s
        k = k0 + i + 1
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = ~esc & (zr * zr + zi * zi > r2)
        scale = jnp.exp2(-k.astype(cr.dtype))
        logr = 0.5 * jnp.log(jnp.maximum(zr * zr + zi * zi, 1e-300))
        gg = logr * scale
        gg = jnp.where(jnp.isfinite(gg) & (gg >= 0.0), gg, 0.0)
        g = jnp.where(hit, gg, g)
        kk = jnp.where(hit, k, kk)
        lpr = jnp.where(hit, logr * scale, lpr)
        lpi = jnp.where(hit, jnp.arctan2(zi, zr) * scale, lpi)
        esc = esc | hit
        zr = jnp.where(esc, 0.0, zr)
        zi = jnp.where(esc, 0.0, zi)
        return zr, zi, esc, g, kk, lpr, lpi

    return jax.lax.fori_loop(0, iters, body, (zr, zi, esc, g, kk, lpr, lpi))


def green_potential_compacted(points, max_iter: int = 20000, escape_r: float = 2.0,
                              stage_iters: int = 512, stage_executor=None):
    """g_M/Phi for a complex cloud with host compaction between stages.

    Identical per-point arithmetic to green_potential — both delegate to
    _green_stage, and a parity test asserts exact equality; after each
    `stage_iters` chunk the non-escaped points are compacted on host, so the
    deep interior (which runs the full max_iter in the reference) no longer
    drags every escaped point along. Measured ~125x on the n=2..200 /
    max_iter=20000 cloud (300 s -> 2.4 s kernel-level; the full pipeline
    drops 312 s -> 26 s). Returns (g, k, phi) numpy arrays.

    stage_executor replaces the per-stage kernel call (same signature as
    _green_stage) — parallel.sharded.green_stage_executor point-shards each
    stage over a mesh with identical per-point arithmetic.
    """
    run_stage = stage_executor if stage_executor is not None else _green_stage
    pts = np.asarray(points, dtype=complex).ravel()
    n = len(pts)
    g = np.zeros(n)
    kk = np.full(n, max_iter, dtype=np.int32)
    phi = np.full(n, np.nan + 1j * np.nan, dtype=complex)
    idx = np.arange(n)
    zr_h = np.zeros(n)
    zi_h = np.zeros(n)
    cr_h = pts.real.copy()
    ci_h = pts.imag.copy()
    r2 = escape_r * escape_r
    k0 = 0
    while k0 < max_iter and len(idx):
        iters = min(stage_iters, max_iter - k0)
        # pad to a power-of-2 bucket so shrinking sizes reuse compilations;
        # padding lanes iterate c = 0 (never escapes, harmless)
        m = len(idx)
        bucket = 1 << max(0, int(np.ceil(np.log2(max(m, 64)))))
        pad = bucket - m
        out = run_stage(
            jnp.asarray(np.pad(zr_h, (0, pad))), jnp.asarray(np.pad(zi_h, (0, pad))),
            jnp.asarray(np.pad(cr_h, (0, pad))), jnp.asarray(np.pad(ci_h, (0, pad))),
            jnp.int32(k0), iters, r2, max_iter,
        )
        from cmtci.utils.artifacts import fetch

        zr_f, zi_f = fetch(out[0])[:m], fetch(out[1])[:m]
        esc = fetch(out[2])[:m]
        if esc.any():
            hit_idx = idx[esc]
            g[hit_idx] = fetch(out[3])[:m][esc]
            kk[hit_idx] = fetch(out[4])[:m][esc]
            er = np.exp(fetch(out[5])[:m][esc])
            phi[hit_idx] = er * np.exp(1j * fetch(out[6])[:m][esc])
            keep = ~esc
            idx = idx[keep]
            zr_h, zi_h = zr_f[keep], zi_f[keep]
            cr_h, ci_h = cr_h[keep], ci_h[keep]
        else:
            zr_h, zi_h = zr_f, zi_f
        k0 += iters
    return g, kk, phi


@functools.partial(jax.jit, static_argnames=("max_iter",))
def green_potential(cr, ci, max_iter: int = 20000, escape_r: float = 2.0):
    """Parameter-plane Green function g_M(c) and Phi(c).

    Reference: lucas_equipotential_test_v3.py:124-162. At first escape k
    (1-based): log_phi = log(z) * 2^-k, g = Re log_phi clamped to >= 0,
    phi = exp(log_phi); else (0, max_iter, nan).
    Returns (g, k, phi_r, phi_i). One _green_stage covering the whole
    iteration budget — the compaction-staged variant below shares the exact
    same loop body by construction.
    """
    zr = jnp.zeros_like(cr)
    zi = jnp.zeros_like(ci)
    _, _, esc, g, kk, lpr, lpi = _green_stage(
        zr, zi, cr, ci, jnp.int32(0), max_iter, escape_r * escape_r, max_iter
    )
    er = jnp.exp(lpr)
    phi_r = jnp.where(esc, er * jnp.cos(lpi), jnp.nan)
    phi_i = jnp.where(esc, er * jnp.sin(lpi), jnp.nan)
    return g, kk, phi_r, phi_i


@functools.partial(jax.jit, static_argnames=("max_iter",))
def de_field_stage1(cr, ci, max_iter: int = 200, bailout: float = 1e6):
    """Stage-1 distance estimator (construct_stage1_clean.py:50-58).

    Scalar-loop semantics: return |z|*log|z| / max(|dz|, 1e-16) at the FIRST
    |z| > bailout (both z and dz latched there), else 0. Note: no factor 2
    in the denominator, unlike the other DE variants.
    """
    zr = jnp.zeros_like(cr)
    zi = jnp.zeros_like(ci)
    dzr = jnp.ones_like(cr)
    dzi = jnp.zeros_like(ci)
    esc = jnp.zeros(cr.shape, dtype=bool)
    lzr = jnp.zeros_like(cr)
    lzi = jnp.zeros_like(ci)
    ldr = jnp.ones_like(cr)
    ldi = jnp.zeros_like(ci)

    def body(_, s):
        zr, zi, dzr, dzi, esc, lzr, lzi, ldr, ldi = s
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = ~esc & (jnp.hypot(zr, zi) > bailout)
        lzr = jnp.where(hit, zr, lzr)
        lzi = jnp.where(hit, zi, lzi)
        ldr = jnp.where(hit, dzr, ldr)
        ldi = jnp.where(hit, dzi, ldi)
        esc = esc | hit
        zr = jnp.where(esc, 0.0, zr)
        zi = jnp.where(esc, 0.0, zi)
        dzr = jnp.where(esc, 1.0, dzr)
        dzi = jnp.where(esc, 0.0, dzi)
        return zr, zi, dzr, dzi, esc, lzr, lzi, ldr, ldi

    out = jax.lax.fori_loop(0, max_iter, body, (zr, zi, dzr, dzi, esc, lzr, lzi, ldr, ldi))
    _, _, _, _, esc, lzr, lzi, ldr, ldi = out
    az = jnp.hypot(lzr, lzi)
    adz = jnp.maximum(jnp.hypot(ldr, ldi), 1e-16)
    d = jnp.where(esc, az * jnp.log(jnp.maximum(az, 1e-300)) / adz, 0.0)
    return esc, d


@functools.partial(jax.jit, static_argnames=("max_iter", "normalization"))
def escape_potential_grid(
    cr, ci, max_iter: int = 500, escape_r: float = 4.0, normalization: str = "two_pow_n"
):
    """Grid escape potential with the reference's three normalizations.

    normalization:
      "two_pow_n":  g = log|z_n| / 2^n at first escape, n 1-based, else 0
                    (variograms_construct_mandelbrot.py:148-166)
      "two_pow_k_break": Potentials.py:32-47 — k is the 0-based loop index at
                    break (or max_iter-1 if no escape); U = log|z_end|/2^k,
                    0 where |z_end| == 0.
      "k_plus_1":   U = log|z_k|/(k+1) at first escape (0-based k), else 0
                    (Laplacian_C-M.py:27-43)
    """
    zr = jnp.zeros_like(cr)
    zi = jnp.zeros_like(ci)
    esc = jnp.zeros(cr.shape, dtype=bool)
    g = jnp.zeros_like(cr)
    r2 = escape_r * escape_r
    kend = jnp.zeros(cr.shape, dtype=jnp.int32)
    lzr = jnp.zeros_like(cr)
    lzi = jnp.zeros_like(ci)

    def body(i, s):
        zr, zi, esc, g, kend, lzr, lzi = s
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = ~esc & (zr * zr + zi * zi > r2)
        logr = 0.5 * jnp.log(jnp.maximum(zr * zr + zi * zi, 1e-300))
        if normalization == "two_pow_n":
            val = logr / jnp.exp2((i + 1).astype(cr.dtype))
        elif normalization == "k_plus_1":
            val = logr / (i + 1).astype(cr.dtype)
        else:  # two_pow_k_break
            val = logr / jnp.exp2(i.astype(cr.dtype))
        g = jnp.where(hit, val, g)
        kend = jnp.where(hit, i, kend)
        lzr = jnp.where(hit | esc, lzr, zr)  # last unescaped z
        lzi = jnp.where(hit | esc, lzi, zi)
        lzr = jnp.where(hit, zr, lzr)
        lzi = jnp.where(hit, zi, lzi)
        esc = esc | hit
        zr = jnp.where(esc, 0.0, zr)
        zi = jnp.where(esc, 0.0, zi)
        return zr, zi, esc, g, kend, lzr, lzi

    zr, zi, esc, g, kend, lzr, lzi = jax.lax.fori_loop(
        0, max_iter, body, (zr, zi, esc, g, kend, lzr, lzi)
    )
    if normalization == "two_pow_k_break":
        # non-escaped points: U = log|z_final| / 2^(max_iter-1), 0 if |z|==0
        a2 = lzr * lzr + lzi * lzi
        tail = 0.5 * jnp.log(jnp.maximum(a2, 1e-300)) / jnp.exp2(
            jnp.asarray(max_iter - 1, dtype=cr.dtype)
        )
        g = jnp.where(esc, g, jnp.where(a2 > 0.0, tail, 0.0))
    return g


@jax.jit
def smooth5(g):
    """Interior 5-point average (variograms_construct_mandelbrot.py:168-173)."""
    out = g
    inner = (g[1:-1, 1:-1] + g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2] + g[1:-1, 2:]) / 5.0
    return out.at[1:-1, 1:-1].set(inner)


# ---------------------------------------------------------------------------
# Boundary proxy samplers (host wrappers; RNG on host for reference parity)
# ---------------------------------------------------------------------------


def de_field_tci_numpy(c: np.ndarray, max_iter: int = 250, escape_r: float = 250.0,
                       eps: float = 1e-12):
    """Host-numpy TCI DE with the reference's exact op order and IEEE overflow.

    Used by parity runs: XLA's FMA contraction can flip a borderline pixel's
    escape iteration on large grids, which derails the shared RNG stream of
    oracle reproductions. Bitwise-identical to
    tci_construct_mandelbrot_v002_fixed.py:35-47.
    """
    z = np.zeros_like(c)
    dz = np.ones_like(c)
    esc = np.zeros(c.shape, bool)
    last = np.zeros_like(c)
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(max_iter):
            dz = 2 * z * dz + 1
            z = z * z + c
            mask = (np.abs(z) > escape_r) & (~esc)
            esc |= mask
            last[mask] = z[mask]
    d = np.zeros(c.shape)
    z_, dz_ = last[esc], dz[esc]
    with np.errstate(over="ignore", invalid="ignore"):
        d[esc] = np.log(np.abs(z_)) * np.abs(z_) / np.maximum(np.abs(2 * z_ * dz_), eps)
    return esc, np.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)


def sample_boundary_quantile(
    domain,
    grid_n: int,
    n_samples: int,
    max_iter: int = 250,
    escape_r: float = 250.0,
    eps: float = 1e-12,
    rng: np.random.RandomState | None = None,
    dtype=jnp.float64,
    impl: str = "jax",
    mesh=None,
):
    """TCI boundary sampler (tci_construct_mandelbrot_v002_fixed.py:49-59).

    Keep escaped points with d <= 25%-quantile of escaped d, then subsample
    to n_samples with numpy RNG (pass np.random to share the reference's
    global-seed stream for bitwise parity runs; impl="numpy" additionally
    pins the orbit arithmetic to numpy's, immune to XLA FMA contraction).
    With impl="jax" and a `mesh`, the DE grid rows are sharded over the
    devices (elementwise orbits, so bitwise-identical to single-device); the
    quantile/subsample stays on host to preserve the RNG stream.
    """
    if impl == "numpy":
        # exact reference grid: np.linspace differs from jnp.linspace at the
        # ulp level, which can flip borderline escape classifications
        xs = np.linspace(domain[0], domain[1], grid_n)
        ys = np.linspace(domain[2], domain[3], grid_n)
        crn, cin = np.meshgrid(xs, ys)
        esc, d = de_field_tci_numpy(crn + 1j * cin, max_iter=max_iter,
                                    escape_r=escape_r, eps=eps)
        cr, ci = crn, cin
    elif impl == "pallas":
        # f32 Pallas head with the same non-latched-dz overflow semantics; the
        # escaped & d<=q25 selection is statistically equivalent to the f64
        # path (f32 dz overflow reclassifies a few late escapers into d==0).
        # The quantile band is selected ON DEVICE and only the bool mask
        # crosses the host link; coordinates come from host numpy (no f64
        # device work).
        if eps != 1e-12:
            # the f32 kernel's denominator floor is baked in; a silently
            # different DE field under de_impl="pallas" vs "jax" would be
            # worse than refusing (ADVICE r2)
            raise ValueError(
                "impl='pallas' hardcodes the 1e-12 DE denominator floor; "
                f"eps={eps} is not representable there — use impl='jax'")
        if mesh is not None:
            raise ValueError(
                "impl='pallas' is a single-device head; it cannot be "
                "combined with mesh= (use impl='jax' for the sharded path)")
        from cmtci.kernels.mandelbrot_pallas import tci_boundary_sample

        # device-side Gumbel top-k subsample: only n_samples int32 indices
        # reach the host per stage instead of the grid_n^2 bool mask (the
        # host RNG seeds the device stream, so stage sequences stay
        # deterministic under the shared-stream convention)
        r = rng if rng is not None else np.random
        seed = int(r.randint(0, 2**31 - 1))
        return tci_boundary_sample(domain, grid_n, n_samples, seed,
                                   max_iter=max_iter, escape_r=escape_r)
    elif mesh is not None:
        from cmtci.parallel.sharded import sharded_de_tci_field

        # build the grid ONCE on the mesh's platform and hand it to the
        # sharded field, which previously rebuilt it
        with jax.default_device(mesh.devices.flat[0]):
            cr, ci = complex_grid(domain, grid_n, grid_n, dtype=dtype)
        esc, d = sharded_de_tci_field(domain, grid_n, mesh, max_iter=max_iter,
                                      escape_r=escape_r, eps=eps, dtype=dtype,
                                      grid=(cr, ci))
    else:
        cr, ci = complex_grid(domain, grid_n, grid_n, dtype=dtype)
        esc, d, _, _ = de_field_tci(cr, ci, max_iter=max_iter, escape_r=escape_r, eps=eps)
    from cmtci.utils.artifacts import fetch

    esc = fetch(esc)
    d = fetch(d)
    if not esc.any():
        raise RuntimeError("No escape points")
    q = np.quantile(d[esc], 0.25)
    c = fetch(cr) + 1j * fetch(ci)
    pts = c[esc & (d <= q)].ravel()
    return _subsample(pts, n_samples, rng)


def _subsample(pts, n_samples: int, rng):
    """Reference subsample (tci_..._v002_fixed.py:56-59): numpy RNG choice
    without replacement only when the pool exceeds the target."""
    if pts.size > n_samples:
        r = rng if rng is not None else np.random
        pts = r.choice(pts, n_samples, replace=False)
    return pts


def boundary_points_threshold(
    domain=(-2.25, 1.25, -1.75, 1.75),
    grid_n: int = 600,
    dist_thresh: float = 0.002,
    max_iter: int = 500,
    escape_r: float = 4.0,
    dtype=jnp.float64,
):
    """Threshold boundary proxy (variograms_construct_mandelbrot.py:90-104)."""
    cr, ci = complex_grid(domain, grid_n, grid_n, dtype=dtype)
    esc, dist, _, _ = de_field_std(cr, ci, max_iter=max_iter, escape_r=escape_r)
    if dtype != jnp.float64:
        # compact on the device: only the count scalar and the selected
        # coordinates are fetched, not the full dist + cr/ci grids
        # (~6 MB at grid_n=700); jnp.nonzero on
        # the row-major ravel selects the same points in the same
        # order as the host boolean indexing below, with the device
        # grid's exact values.
        mask = (esc & (dist <= dist_thresh)).ravel()
        n_sel = int(jnp.sum(mask))
        idx = jnp.nonzero(mask, size=n_sel)[0]
        pts = np.asarray(jnp.stack([cr.ravel()[idx], ci.ravel()[idx]]),
                         dtype=np.float64)
        return pts[0] + 1j * pts[1]
    esc = np.asarray(esc)
    dist = np.asarray(dist)
    c = np.asarray(cr) + 1j * np.asarray(ci)
    return c[esc & (dist <= dist_thresh)]
