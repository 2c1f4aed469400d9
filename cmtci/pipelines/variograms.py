"""Variogram pipeline (BASELINE config 3).

Reference: variograms_construct_mandelbrot.py main (:320-399) — cloud +
DE-threshold boundary proxy, shared grid, log potential (U_C) and smoothed
escape potential (U_M), min-max normalization, semivariograms + cross, CSV.
The v2 additions (2D polynomial detrend, exponential model fit) are exposed
via options (variograms_construct_mandelbrotv2.py:179-235).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci.io import writers
from cmtci.kernels import companion, mandelbrot as mb
from cmtci.kernels.potential import cloud_log_potential
from cmtci.stats import variogram as vg


@dataclass
class VariogramConfig:
    # "float32" runs the all-pairs binning on the device via the scatter-free
    # masked-reduction kernel (gamma within ~4e-6 of f64)
    vario_dtype: str = "float64"
    # "float32" computes the DE boundary proxy, escape potential and cloud
    # log-potential on the device in f32 (f32 flips borderline DE-threshold
    # points only)
    field_dtype: str = "float64"
    n_list: tuple = (30, 60, 90, 120, 180, 240, 300)
    boundary_grid: int = 700
    dist_thresh: float = 0.0018
    boundary_max_iter: int = 600
    domain: tuple = (-2.25, 1.25, -1.75, 1.75)
    grid_nx: int = 256
    grid_ny: int = 256
    potential_max_iter: int = 600
    potential_r: float = 4.0
    log_pot_eps: float = 1e-6
    rmax: float = 1.3
    nbins: int = 35
    detrend: bool = False
    fit_model: bool = False
    m_target: int = 15000
    seed: int = 42
    cloud_backend: str = "aberth"


def run_variograms(cfg: VariogramConfig, out_csv: str | None = None,
                   mesh=None):
    import jax.numpy as jnp

    rng = np.random.RandomState(cfg.seed)
    f32 = cfg.field_dtype == "float32"
    fdt = jnp.float32 if f32 else jnp.float64
    c_pts = companion.inverse_cloud(list(cfg.n_list), "lucas_all_ones", tol=1e-14,
                                    backend=cfg.cloud_backend)
    m_pts = mb.boundary_points_threshold(
        domain=cfg.domain, grid_n=cfg.boundary_grid, dist_thresh=cfg.dist_thresh,
        max_iter=cfg.boundary_max_iter, dtype=fdt,
    )

    xs = np.linspace(cfg.domain[0], cfg.domain[1], cfg.grid_nx)
    ys = np.linspace(cfg.domain[2], cfg.domain[3], cfg.grid_ny)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")

    # U_C = (1/N) sum log(1/(r+eps)) (variograms_construct_mandelbrot.py:128-146)
    u_c = np.asarray(cloud_log_potential(
        np.asarray(gx, dtype=np.float32 if f32 else np.float64),
        np.asarray(gy, dtype=np.float32 if f32 else np.float64),
        c_pts, eps=cfg.log_pot_eps, sign=-1))
    cr, ci = mb.complex_grid(cfg.domain, cfg.grid_nx, cfg.grid_ny, dtype=fdt)
    u_m = np.asarray(mb.escape_potential_grid(cr, ci, max_iter=cfg.potential_max_iter,
                                              escape_r=cfg.potential_r,
                                              normalization="two_pow_n"))
    u_m = np.asarray(mb.smooth5(u_m))

    def norm(u):
        return (u - np.nanmin(u)) / (np.nanmax(u) - np.nanmin(u) + 1e-12)

    u_c_n, u_m_n = norm(u_c), norm(u_m)
    if cfg.detrend:
        u_c_n, _ = vg.detrend_poly2d(u_c_n, gx, gy)
        u_m_n, _ = vg.detrend_poly2d(u_m_n, gx, gy)

    r_bins = np.linspace(0.0, cfg.rmax, cfg.nbins + 1)
    import jax.numpy as jnp

    dt = jnp.float32 if cfg.vario_dtype == "float32" else None
    # one fused device call for all three binnings on the f32 path (same
    # host-RNG draw order as the sequential calls); f64 stays sequential;
    # a mesh shards the three binnings' i-rows over its
    # devices (SURVEY §5.8 data parallelism)
    r_c, g_c, g_m, g_x, _, _, _ = vg.three_semivariograms(
        u_c_n, u_m_n, gx, gy, r_bins, cfg.m_target, rng, dtype=dt, mesh=mesh)

    out = {
        "r": r_c, "gamma_construct": g_c, "gamma_mandelbrot": g_m, "gamma_cross": g_x,
        "U_C": u_c, "U_M": u_m, "n_construct": len(c_pts), "n_boundary": len(m_pts),
    }
    if cfg.fit_model:
        out["fit_construct"] = vg.fit_exponential_variogram(r_c, g_c)
        out["fit_mandelbrot"] = vg.fit_exponential_variogram(r_c, g_m)
    if out_csv:
        import os as _os

        writers.ensure_dir(out_csv)
        writers.write_config_meta(f"{_os.path.splitext(out_csv)[0]}_meta.txt", cfg)
        import csv as _csv

        with open(out_csv, "w", newline="") as f:
            w = _csv.writer(f)
            w.writerow(["r_center", "gamma_Construct", "gamma_Mandelbrot", "gamma_cross"])
            for i in range(len(r_c)):
                w.writerow([r_c[i], g_c[i], g_m[i], g_x[i]])
    return out
