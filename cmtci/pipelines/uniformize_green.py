"""Boundary-integral Riemann-map pipeline (P2, call stack SURVEY §3.3).

Reference: lucas_to_cardioid_v40_reference.py main (:476-671): lucas
boundary points -> alpha polygon -> fit Riemann map -> 20k interior samples
-> Phi / f -> radii clamp -> exact disk->cardioid map -> inverse check ->
one-row diagnostics CSV + radii histogram CSV + NPZ map state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci.geometry import alpha_shape
from cmtci.geometry.cardioid import cardioid_to_disk, disk_to_cardioid
from cmtci.geometry.polygon import sample_interior_points, slightly_inside
from cmtci.io import writers
from cmtci.maps import riemann


@dataclass
class GreenUniformizeConfig:
    alpha: float = 4.5
    n_bdy: int = 2000
    gauss_n: int = 16
    ridge: float = 1e-8
    target_r_clamp: float = 0.995
    inward_eps: float = 1e-3
    interior_n: int = 20000
    interior_seed: int = 0
    interior_max_tries: int = 2_000_000
    enable_jitter: bool = True
    do_inverse_check: bool = True
    # "float32" runs the hot map evaluations (Phi quadrature + log-kernel
    # modulus, 20000x2000) on the default device in f32 with the documented error
    # budget: Im Phi mod 2pi p99 ~1e-5 rad, g abs err <= 1e-4. The dense
    # lstsq fit and g_shift calibration stay f64 on the host.
    map_dtype: str = "float64"
    # "alpha" reproduces v40 (unique+jitter destroys the input ordering, then
    # the alpha shape recovers a polygon — fragmentary for smooth boundary
    # polylines: for the default lucas_points.npy it selects a 0.04-area lump
    # of the domain, and faithfully so). "ordered" treats the input as an
    # ordered closed boundary and maps the FULL domain.
    polygon_source: str = "alpha"


def run_green_uniformization(lucas_points_xy, cfg: GreenUniformizeConfig,
                             out_dir: str | None = None, verbose: bool = False,
                             cache_dir: str | None = None, timer=None):
    """Returns dict with the map, samples, and the v40 diagnostics row.

    With cache_dir the fitted map state (the dense N_BDY lstsq, the
    pipeline's one-time cost) is cached keyed by (input-points digest, fit
    config) — the array-native form of the reference's reusable map-state NPZ
    (lucas_to_cardioid_v40_reference.py:655-668).
    """
    from dataclasses import asdict

    from cmtci.utils import artifacts
    from cmtci.utils.artifacts import StageTimer

    timer = timer if timer is not None else StageTimer()
    if cfg.polygon_source not in ("alpha", "ordered"):
        raise ValueError(f"unknown polygon_source '{cfg.polygon_source}'")
    pts = np.ascontiguousarray(np.asarray(lucas_points_xy, dtype=float))
    with timer.stage("polygon"):
        if cfg.polygon_source == "ordered":
            from cmtci.geometry.polygon import Polygon
            from cmtci.geometry.resample import enforce_ccw

            poly_l = Polygon(enforce_ccw(pts))
        else:
            pts = np.unique(pts, axis=0)
            if cfg.enable_jitter:
                rng = np.random.default_rng(0)
                pts = pts + 1e-12 * rng.standard_normal(pts.shape)
            poly_l = alpha_shape.alpha_shape_polygon(pts, cfg.alpha)

    fresh_kds = []

    def _fit():
        # the f32 perf path takes the device-f32 QR fit (σ to 1.9e-7 of the
        # reference lstsq, dense flops on the device, f64 host-residual
        # refinement); the f64 parity path keeps np.linalg.lstsq
        rm = riemann.fit_riemann_map(poly_l, n_bdy=cfg.n_bdy, ridge=cfg.ridge,
                                     inward_eps=cfg.inward_eps, gauss_n=cfg.gauss_n,
                                     verbose=verbose,
                                     solver="qr32" if cfg.map_dtype == "float32"
                                     else "lstsq",
                                     # f32 path: g_shift derives from the
                                     # fused phi_f_eval call below, which
                                     # evaluates the same inward-shifted
                                     # boundary nodes anyway — the fit's
                                     # host N×N calibration block was pure
                                     # duplication
                                     calibrate_g_shift=cfg.map_dtype != "float32")
        # the N×N kernel is too big for the cached state; hand the fresh
        # one to the caller so a cache MISS doesn't pay a second assembly
        fresh_kds.append(rm._kds)
        return {"bdy_z": rm.bdy_z, "ds": rm.ds, "sigma": rm.sigma,
                "a": np.complex128(rm.a), "c": np.float64(rm.c),
                "g_shift": np.float64(rm.g_shift)}

    # the interior rejection sampler (pure host numpy, its own RNG) and the
    # fit (device QR + host refinement) are independent — overlap them,
    # the same pattern as the tracker's cloud/sample overlap
    from concurrent.futures import ThreadPoolExecutor

    with timer.stage("fit+interior_sample"):
        with ThreadPoolExecutor(1) as ex:
            fut_int = ex.submit(sample_interior_points, poly_l, cfg.interior_n,
                                cfg.interior_seed, cfg.interior_max_tries)
            # key ONLY on fields the fit depends on (polygon + solver knobs):
            # sampling/diagnostic knobs (interior_*, target_r_clamp,
            # do_inverse_check) must not invalidate the cached dense fit
            fit_fields = ("alpha", "n_bdy", "gauss_n", "ridge", "inward_eps",
                          "enable_jitter", "map_dtype", "polygon_source")
            cfg_dict = asdict(cfg)
            fit_key = {**{k: cfg_dict[k] for k in fit_fields},
                       "points": artifacts.array_digest(lucas_points_xy)}
            st = artifacts.cached("riemann_fit", fit_key, _fit,
                                  cache_dir=cache_dir or ".cmtci_cache",
                                  enabled=cache_dir is not None)
            rm = riemann.RiemannMapGreenModulus(
                bdy_z=np.asarray(st["bdy_z"]), ds=np.asarray(st["ds"]),
                sigma=np.asarray(st["sigma"]), a=complex(st["a"]),
                c=float(st["c"]), g_shift=float(st["g_shift"]), gauss_n=cfg.gauss_n,
            )
            if fresh_kds and fresh_kds[0] is not None:
                rm._kds = fresh_kds[0]
            elif cfg.map_dtype == "float32":
                # reconstructed from a cached state (no kernel); the
                # diagnostics stage's boundary_residual needs one. The fast
                # threaded form matches the qr32 fit's own kds (the f64
                # parity path keeps boundary_residual's exact-form
                # memoized assembly)
                rm._kds = riemann._log_kernel_ds_fast(rm.bdy_z, rm.ds)
            z_int, tries = fut_int.result()
    import jax.numpy as jnp

    dt = jnp.float32 if cfg.map_dtype == "float32" else None
    with timer.stage("phi_f_eval"):
        # ONE fused device call: g on interior+boundary-in points, Im Φ_raw
        # on the interior points. Re Φ IS g (v40:259-264) and
        # f = exp(-g)·exp(-i·Im Φ_raw), so the rm.phi + rm.f + rm.f(bdy) +
        # rm.g_real(bdy) sequence would evaluate the same two kernels six
        # times across four dispatches for nothing.
        z_bdy_in = slightly_inside(rm.bdy_z, rm.a, cfg.inward_eps)
        if cfg.map_dtype == "float32":
            # derive g_shift from THIS evaluation (median g(bdy-in) = 0,
            # the v40 calibration contract); zeroing first makes the result
            # independent of whether a cached fit recorded a shift
            rm.g_shift = 0.0
        g_all, im_int = rm.eval_g_phi(np.concatenate([z_int, z_bdy_in]),
                                      z_int, dtype=dt)
        if cfg.map_dtype == "float32":
            shift = -float(np.median(g_all[len(z_int):]))
            rm.g_shift = shift
            g_all = g_all + shift
        g_int, g_in = g_all[: len(z_int)], g_all[len(z_int):]
        re_phi = g_int
        w_raw = riemann.safe_exp_minus_real(g_int) * np.exp(-1j * im_int)
    rad_raw = np.abs(w_raw)
    finite = np.isfinite(rad_raw)
    rad_f = rad_raw[finite]

    # clamp to the disk (v40:140-147, vectorized)
    r = np.abs(w_raw)
    scale = np.where(np.isfinite(r) & (r > cfg.target_r_clamp),
                     cfg.target_r_clamp / np.where(r == 0, 1.0, r), 1.0)
    w = np.where(np.isfinite(r), w_raw * scale, np.nan + 1j * np.nan)
    rad = np.abs(w)
    mapped = disk_to_cardioid(w)

    err = np.array([])
    if cfg.do_inverse_check:
        err = np.abs(cardioid_to_disk(mapped) - w)
        err = err[np.isfinite(err)]

    with timer.stage("diagnostics"):
        # |f| = exp(-g) exactly (the phase factor has unit modulus), so the
        # boundary-modulus contract needs only the g_in already evaluated
        mod_bdy = riemann.safe_exp_minus_real(g_in)
        resid = rm.boundary_residual()

    row = dict(
        version="cmtci_green_uniformization",
        N_BDY=cfg.n_bdy, PATH_GAUSS_N=cfg.gauss_n, RIDGE_LAMBDA=cfg.ridge,
        INWARD_EPS=cfg.inward_eps, INTERIOR_N=int(len(z_int)),
        a_real=float(rm.a.real), a_imag=float(rm.a.imag), g_shift=float(rm.g_shift),
        bdy_mod_median=float(np.median(mod_bdy)),
        bdy_mod_p90=float(np.quantile(mod_bdy, 0.90)),
        bdy_mod_min=float(mod_bdy.min()), bdy_mod_max=float(mod_bdy.max()),
        bdy_resid_median=float(np.median(resid)),
        bdy_resid_p90_abs=float(np.quantile(np.abs(resid), 0.90)),
        bdy_resid_max_abs=float(np.max(np.abs(resid))),
        g_bdy_in_min=float(g_in.min()), g_bdy_in_median=float(np.median(g_in)),
        g_bdy_in_max=float(g_in.max()),
        RePhi_int_min=float(re_phi.min()), RePhi_int_median=float(np.median(re_phi)),
        RePhi_int_max=float(re_phi.max()),
        rad_raw_median=float(np.median(rad_f)), rad_raw_p90=float(np.quantile(rad_f, 0.90)),
        rad_raw_max=float(rad_f.max()),
        rad_clamped_median=float(np.nanmedian(rad)),
        rad_clamped_p90=float(np.nanquantile(rad, 0.90)),
        rad_clamped_max=float(np.nanmax(rad)),
    )
    if len(err):
        row.update(inverse_err_median=float(np.median(err)),
                   inverse_err_p90=float(np.quantile(err, 0.90)),
                   inverse_err_max=float(err.max()))

    if out_dir:
        writers.write_config_meta(f"{out_dir}/meta.txt", cfg,
                                  extra={"n_input_points": len(pts)})
        writers.write_dict_rows_csv(f"{out_dir}/diagnostics.csv", [row])
        writers.write_hist_csv(f"{out_dir}/radii_hist_w_raw.csv", rad_f, bins=80,
                               range_=(0.0, 1.05))
        writers.ensure_dir(f"{out_dir}/map_state.npz")
        np.savez(f"{out_dir}/map_state.npz", lucas_interior=z_int,
                 disk_points_raw=w_raw, disk_points=w, cardioid_points=mapped,
                 rmL_a=rm.a, rmL_sigma=rm.sigma, rmL_C=rm.c,
                 rmL_g_shift=rm.g_shift, rmL_bdy=rm.bdy_z, rmL_ds=rm.ds,
                 inverse_err=err)
    return {"map": rm, "interior": z_int, "disk": w, "cardioid": mapped,
            "diagnostics": row, "stage_times": dict(timer.times)}
