"""Iterative variogram <-> Laplacian coupling pipeline (P5).

Reference: Iterative_Variogram_Laplacian.py:156-307 — per iteration:
matching-distance variogram -> range a -> gaussian-smooth U_C (sigma from
a) -> Laplacians -> global/local correlations -> nudge C toward matched M
with distance-weighted learning rate.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from cmtci.io import writers
from cmtci.kernels import mandelbrot as mb
from cmtci.kernels.potential import cloud_log_potential
from cmtci.stats import fields, variogram as vg
from cmtci.transport.histogram import (_sep_correlate_nearest,
                                       gaussian_filter_nearest,
                                       gaussian_kernel1d)


@functools.partial(jax.jit, static_argnames=("radii", "win", "chunk"))
def _all_iters_device(gx, gy, pxw, ns, u_m, lap_m, kernels, h,
                      radii: tuple, win: int, chunk: int):
    """EVERY iteration's diagnostics in ONE dispatch (f32 fast path).

    The diagnostics never feed the nudge (the trajectory is host f64:
    dists/variogram/weights only), so the full nudge loop runs first and
    the per-iteration (cloud snapshot, smoothing kernel) pairs evaluate
    here as one compiled graph — one launch per RUN instead of one per
    iteration (4 launches + 4 scalar fetches before). Kernel lengths are shape-static via the `radii`
    tuple: each distinct per-run radius profile compiles once (absorbed
    by the persistent cache; the bench/oracle configs reuse one profile).
    Returns ((n_iter, 2) scalars, (n_iter,) local maps, (n_iter,) u_c_s)."""
    scal, locs, fields_s = [], [], []
    for i, radius in enumerate(radii):
        s, l, u = _iter_device(gx, gy, pxw[i, 0], pxw[i, 1], pxw[i, 2],
                               ns[i], u_m, lap_m, kernels[i], h,
                               radius=radius, win=win, chunk=chunk)
        scal.append(s)
        locs.append(l)
        fields_s.append(u)
    return jnp.stack(scal), jnp.stack(locs), jnp.stack(fields_s)


@functools.partial(jax.jit, static_argnames=("radius", "win", "chunk"))
def _iter_device(gx, gy, px, py, w, n, u_m, lap_m, kernel, h,
                 radius: int, win: int, chunk: int):
    """One full iteration's device work fused in ONE dispatch (f32 path).

    cloud log-potential -> smooth -> laplacian -> global Pearsons ->
    local-correlation map in one compiled graph; only the 2-scalar vector
    is fetched per iteration (the maps stay device-side unless artifacts
    are written). One dispatch per iteration instead of two — the split
    potential/diagnostics structure paid 4 extra roundtrips per run. Recompiles once per distinct gaussian
    radius — the kernel length is shape-static — which the persistent
    compile cache absorbs."""
    from cmtci.kernels.potential import _accumulate

    u_c = _accumulate(gx, gy, px, py, w, gx.dtype.type(1e-12), 1, chunk) / n
    h = jnp.asarray(h, u_c.dtype)  # keep the f32 graph f32 (x64 is on)
    u_c_s = _sep_correlate_nearest(u_c, kernel, radius)
    lap_c = fields.laplacian5(u_c_s, h)
    scalars = jnp.stack([fields.pearson_global_device(u_c_s, u_m),
                         fields.pearson_global_device(lap_c, lap_m)])
    return scalars, fields._local_corr(u_c_s, u_m, win), u_c_s


@dataclass
class CouplingConfig:
    n_iter: int = 4
    vario_bins: int = 50
    grid_res: int = 300
    max_iter_mb: int = 300
    escape_rad: float = 10.0
    nudge_alpha: float = 0.25
    smooth_factor: float = 1.0
    vario_percent: float = 0.90
    win_local_corr: int = 12
    # "float32" evaluates the two potential fields (U_M escape grid, per-
    # iteration U_C cloud log-potential — the f64 pipeline's entire cost,
    # ~2.5 s per iteration on one host core) AND the smooth/Laplacian/
    # correlation diagnostics on the default device, fetching two scalars
    # per iteration. The nudge trajectory is UNCHANGED bitwise: the fields
    # feed only the corr_pot/corr_lap/local-correlation diagnostics, never
    # the cloud update (dists/variogram/weights are host f64 either way);
    # the f32 diagnostics agree to ~1e-5 (corr_pot) / ~1e-3 (corr_lap —
    # the laplacian stencil divides f32 rounding by h²). Test-pinned.
    field_dtype: str = "float64"
    # "float32" moves the per-iteration O(n²) point variogram to the default
    # device too (point_variogram_device: blocked masked reductions, one
    # dispatch + one packed fetch). UNLIKE field_dtype this changes the
    # nudge trajectory realization: a_est feeds sigma_px and the nudge
    # scale, and the f32 gamma differs from host f64 at ~1e-5 relative —
    # the documented opt-in for beyond-reference cloud sizes (the host pair
    # scan is minutes at 5k+ points on a 1-core host; the device call is
    # milliseconds). Counts accumulate in exact int32 (no f32 rounding),
    # though f32 distances can land borderline pairs one bin over vs f64.
    vario_dtype: str = "float64"


def run_coupling(c_pts, m_pts, matches, cfg: CouplingConfig,
                 out_prefix: str | None = None, mesh=None):
    """Returns summary rows + final nudged cloud.

    With `mesh` (a jax.sharding.Mesh) the two O(n²)-class stages shard over
    it: the per-iteration U_C cloud log-potential grid rides
    parallel.sharded.sharded_cloud_potential (row-sharded) and the point
    variogram rides sharded_point_variogram (pair-rows sharded); the
    diagnostics then run per iteration (the single-chip fused-snapshot f32
    path is bypassed — it exists to amortize per-launch cost on one
    device).
    """
    if matches is None:
        raise ValueError(
            "coupling requires matches (matches_indices.csv missing or "
            "unreadable in the bus directory — rerun `cmtci stage1`)")
    c = np.asarray(c_pts, dtype=float).copy()
    m = np.asarray(m_pts, dtype=float)
    matches = np.asarray(matches, dtype=int)

    allp = np.vstack([c, m])
    xmin, ymin = allp.min(axis=0) - 0.5
    xmax, ymax = allp.max(axis=0) + 0.5
    gx1 = np.linspace(xmin, xmax, cfg.grid_res)
    gy1 = np.linspace(ymin, ymax, cfg.grid_res)
    h = gx1[1] - gx1[0]
    gxx, gyy = np.meshgrid(gx1, gy1)
    cr, ci = gxx, gyy  # the escape grid rides the same meshgrid layout

    f32 = cfg.field_dtype == "float32"
    # the potential kernels follow the grid dtype
    gxp = gxx.astype(np.float32) if f32 else gxx
    gyp = gyy.astype(np.float32) if f32 else gyy

    # U_M is static (escape potential, log|z|/(k+1) head, R=10). f32 keeps
    # U_M (and its Laplacian) resident on the device: the per-iteration
    # diagnostics run there too, so the host never needs it unless
    # artifacts are written.
    u_m_dev = mb.escape_potential_grid(gxp, gyp, max_iter=cfg.max_iter_mb,
                                       escape_r=cfg.escape_rad,
                                       normalization="k_plus_1")
    if f32:
        lap_m_dev = fields.laplacian5(u_m_dev, np.float32(h))
        u_m = None  # fetched (f64) only if plotting needs it
        gx_dev = jnp.asarray(gxp)  # grid rides to the device ONCE
        gy_dev = jnp.asarray(gyp)
    else:
        u_m = np.asarray(u_m_dev)
    if mesh is not None and f32:
        # mesh runs take the per-iteration diagnostics branch below
        u_m = np.asarray(u_m_dev, dtype=np.float64)
    fused32 = f32 and mesh is None
    rows = []
    snaps = []  # f32 path: per-iteration (cloud snapshot, smoothing kernel)
    vario32 = cfg.vario_dtype == "float32"
    for it in range(1, cfg.n_iter + 1):
        matched_m = m[matches]
        dists = np.linalg.norm(c - matched_m, axis=1)
        if mesh is not None:
            from cmtci.parallel.sharded import sharded_point_variogram

            lags, gamma, counts = sharded_point_variogram(
                c, dists, nbins=cfg.vario_bins, mesh=mesh,
                dtype=jnp.float32 if vario32 else None)
        elif vario32:
            lags, gamma, counts = vg.point_variogram_device(
                c, dists, nbins=cfg.vario_bins, dtype=jnp.float32)
        else:
            lags, gamma, counts = vg.point_variogram(c, dists, nbins=cfg.vario_bins)
        a_est = vg.variogram_range(lags, gamma, cfg.vario_percent)

        sigma_px = 1.0 if (a_est is None or a_est <= 0) else max(
            0.5, cfg.smooth_factor * (a_est / h) / 2.0
        )
        if fused32:
            # the diagnostics never feed the nudge: snapshot the cloud and
            # kernel, evaluate EVERY iteration's diagnostics in one fused
            # dispatch after the host trajectory completes (one launch per
            # run instead of one per iteration)
            kernel_np = gaussian_kernel1d(sigma_px)
            snaps.append((c.copy(), kernel_np))
            corr_pot = corr_lap = np.nan  # filled from the fused call below
        else:
            if mesh is not None:
                from cmtci.parallel.sharded import sharded_cloud_potential

                # row-shard U_C over the mesh; pad ny to a mesh multiple
                # with an EXTENDED domain at the same dy, then crop (the
                # first grid_res rows are the exact linspace nodes)
                n_dev = mesh.devices.size
                ny = cfg.grid_res
                ny_pad = ((ny + n_dev - 1) // n_dev) * n_dev
                dyg = (ymax - ymin) / (ny - 1)
                dom_pad = (xmin, xmax, ymin, ymin + dyg * (ny_pad - 1))
                u_c = np.asarray(sharded_cloud_potential(
                    dom_pad, cfg.grid_res, ny_pad, c, mesh, eps=1e-12,
                    sign=1,
                    dtype=jnp.float32 if f32 else jnp.float64))[:ny]
            else:
                # the O(grid² · N) pairwise potential follows the grid dtype
                u_c = np.asarray(cloud_log_potential(gxp, gyp, c,
                                                     eps=1e-12, sign=1))
            u_c_s = np.asarray(gaussian_filter_nearest(u_c, sigma_px))
            lap_c = np.asarray(fields.laplacian5(u_c_s, h))
            lap_m = np.asarray(fields.laplacian5(u_m, h))
            corr_pot = fields.pearson_global(u_c_s, u_m)
            corr_lap = fields.pearson_global(lap_c, lap_m)
            local = fields.local_correlation(u_c_s, u_m, cfg.win_local_corr)

        rows.append(dict(iter=it, vario_range_a=float(a_est) if a_est else np.nan,
                         sigma_px=float(sigma_px), corr_pot=corr_pot, corr_lap=corr_lap,
                         d_mean=float(np.nanmean(dists)), d_median=float(np.nanmedian(dists)),
                         d_max=float(np.nanmax(dists))))
        if out_prefix:
            writers.ensure_dir(f"{out_prefix}_{it}_variogram_construct.csv")
            np.savetxt(f"{out_prefix}_{it}_variogram_construct.csv",
                       np.c_[lags, gamma, counts], delimiter=",",
                       header="lag,gamma,count", comments="")
            if not fused32:  # fused-path grid artifacts come from below
                np.save(f"{out_prefix}_{it}_localcorr.npy", local)
                from cmtci.io import plots

                plots.plot_local_correlation_panels(
                    u_c_s, u_m, local, (xmin, xmax, ymin, ymax),
                    f"{out_prefix}_{it}_potential_comparison_with_corrmap.png")

        # nudge (Iterative_Variogram_Laplacian.py:281-295)
        maxd = np.nanmax(dists) if np.isfinite(np.nanmax(dists)) and np.nanmax(dists) > 0 else 1.0
        weights = 1.0 - dists / (maxd + 1e-12)
        scale = 1.0 if (a_est is None or a_est <= 0) else min(2.0, max(0.1, a_est))
        lr = cfg.nudge_alpha * (scale / (scale + 1.0))
        c = c + lr * weights[:, None] * (matched_m - c)

    if fused32 and snaps:
        chunk = 2048
        n_c = len(snaps[0][0])
        n_pad = ((n_c + chunk - 1) // chunk) * chunk
        # fuse in groups of <= _FUSE_MAX iterations: the dispatch unrolls
        # one O(grid²·N) subgraph per iteration, so an unbounded n_iter
        # would grow compile time (and the radii-tuple cache key space)
        # linearly. The default/oracle n_iter=4 stays
        # one group (same compiled graph as before); 50 iterations pay 7
        # launches instead of one graph 12x the tested size.
        _FUSE_MAX = 8
        scal_parts, local_parts, ucs_parts = [], [], []
        for g0 in range(0, len(snaps), _FUSE_MAX):
            grp = snaps[g0 : g0 + _FUSE_MAX]
            pxw = np.zeros((len(grp), 3, n_pad), dtype=np.float32)
            for i, (ci, _) in enumerate(grp):
                pxw[i, 0, :n_c] = ci[:, 0]
                pxw[i, 1, :n_c] = ci[:, 1]
                pxw[i, 2, :n_c] = 1.0
            kernels = [jnp.asarray(k, np.float32) for _, k in grp]
            radii = tuple((len(k) - 1) // 2 for _, k in grp)
            s, l, u = _all_iters_device(
                gx_dev, gy_dev, jnp.asarray(pxw),
                jnp.full(len(grp), n_c, np.float32),
                u_m_dev, lap_m_dev, kernels, h,
                radii=radii, win=int(cfg.win_local_corr), chunk=chunk)
            scal_parts.append(np.asarray(s))
            local_parts.append(l)
            ucs_parts.append(u)
        scal = np.concatenate(scal_parts, axis=0)
        local_dev = (local_parts[0] if len(local_parts) == 1
                     else jnp.concatenate(local_parts, axis=0))
        u_c_s_dev = (ucs_parts[0] if len(ucs_parts) == 1
                     else jnp.concatenate(ucs_parts, axis=0))
        for i, row in enumerate(rows):
            row["corr_pot"] = float(scal[i, 0])
            row["corr_lap"] = float(scal[i, 1])
        if out_prefix:  # artifacts want the host f64 frames
            from cmtci.io import plots

            u_c_s_all = np.asarray(u_c_s_dev, dtype=np.float64)
            local_all = np.asarray(local_dev)
            if u_m is None:
                u_m = np.asarray(u_m_dev, dtype=np.float64)
            w = int(cfg.win_local_corr)
            for i in range(len(snaps)):
                ny, nx = u_c_s_all[i].shape
                local = np.full((ny, nx), np.nan)
                local[w:ny - w, w:nx - w] = local_all[i]
                np.save(f"{out_prefix}_{i + 1}_localcorr.npy", local)
                plots.plot_local_correlation_panels(
                    u_c_s_all[i], u_m, local, (xmin, xmax, ymin, ymax),
                    f"{out_prefix}_{i + 1}_potential_comparison_with_corrmap.png")

    if out_prefix:
        writers.write_dict_rows_csv(f"{out_prefix}_summary_metrics.csv", rows)
        writers.write_config_meta(f"{out_prefix}_meta.txt", cfg,
                                  extra={"n_construct": len(c), "n_mandel": len(m)})
    return rows, c
