"""Remaining analysis pipelines: multifractal, embeddings, symmetry, TCI flow,
spatial stats (phase2/3), and the integrative report (phase5).

References: multifractal_phase6.py, dynamical_embeddings_phase7.py,
symmetry_phase_bestaxis.py, tci_construct_mandelbrot_v002_fixed.py main,
spatial_stats_phase2/3.py, phase5_report.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci.io import writers
from cmtci.stats import (
    curvature as curv,
    embeddings as emb,
    multifractal as mf,
    pointstats as ps,
    spectral as sp,
    symmetry as sym,
)
from cmtci.transport import giflow, histogram as hg
from cmtci.transport.procrustes import procrustes_align_no_scale
from cmtci.transport.sinkhorn import entropic_argmax_match


def run_multifractal(c_pts, m_pts, q_values=None, scales=None, out_prefix=None,
                     box_backend="host", box_dtype=None):
    """Both clouds through the box-counting spectrum; CSV per cloud.

    box_backend="device" computes the counts/partition sums on the default
    jax device (pass box_dtype=jnp.float32 on a GPU session)."""
    res_c = mf.multifractal_spectrum(c_pts, q_values, scales,
                                     backend=box_backend, dtype=box_dtype)
    res_m = mf.multifractal_spectrum(m_pts, q_values, scales,
                                     backend=box_backend, dtype=box_dtype)
    if out_prefix:
        for res, name in ((res_c, "construct"), (res_m, "mandel")):
            out = np.column_stack((res["q"], res["tau"], res["Dq"], res["alpha"], res["f_alpha"]))
            writers.ensure_dir(f"{out_prefix}_{name}_multifractal.csv")
            np.savetxt(f"{out_prefix}_{name}_multifractal.csv", out, delimiter=",",
                       header="q,tau,Dq,alpha,f_alpha", comments="")
        from cmtci.io import plots

        plots.plot_multifractal_compare(res_c, res_m, out_prefix)
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "q_values": list(np.asarray(res_c["q"])),
            "scales": list(np.asarray(res_c["scales"])),
            "n_construct": len(np.asarray(c_pts)), "n_mandel": len(np.asarray(m_pts))})
    return {"construct": res_c, "mandel": res_m}


def run_embeddings(c_pts, m_pts, k_nn=20, n_eigs=8, eps_scale=0.5, out_prefix=None,
                   eig_backend="scipy", eig_dtype=None, knn_dtype=None):
    """Diffusion-map embeddings + spectral distance (phase7).

    eig_backend="device" runs the dense-Lanczos eigensolver on the default
    jax device (pass eig_dtype=jnp.float32 on a GPU session) instead of the
    scipy eigsh parity oracle; knn_dtype=jnp.float32 moves the blocked kNN
    there too (the pipeline's wall at 5k+ points)."""
    vals_c, vecs_c, sigma_c = emb.diffusion_map(c_pts, k_nn, n_eigs, eps_scale,
                                                eig_backend=eig_backend,
                                                eig_dtype=eig_dtype,
                                                knn_dtype=knn_dtype)
    vals_m, vecs_m, sigma_m = emb.diffusion_map(m_pts, k_nn, n_eigs, eps_scale,
                                                eig_backend=eig_backend,
                                                eig_dtype=eig_dtype,
                                                knn_dtype=knn_dtype)
    dist = emb.embedding_spectral_distance(vals_c, vals_m)
    if out_prefix:
        for vals, vecs, name in ((vals_c, vecs_c, "construct"), (vals_m, vecs_m, "mandel")):
            writers.ensure_dir(f"{out_prefix}_eigenvalues_{name}.csv")
            np.savetxt(f"{out_prefix}_eigenvalues_{name}.csv",
                       np.column_stack((np.arange(1, len(vals) + 1), vals)),
                       delimiter=",", header="idx,lambda")
            np.save(f"{out_prefix}_eigenvectors_{name}.npy", vecs)
        with open(f"{out_prefix}_spectral_distance.txt", "w") as f:
            f.write(f"spectral_distance_norm = {dist}\n")
        from cmtci.io import plots

        plots.plot_eigenvalue_spectra(vals_c, vals_m, f"{out_prefix}_spectra_compare.png")
        for pts, vecs, name in ((c_pts, vecs_c, "construct"), (m_pts, vecs_m, "mandel")):
            comp = 1 if vecs.shape[1] >= 3 else 0
            plots.plot_embedding_scatter(
                pts, vecs[:, comp], f"{out_prefix}_{name}_embedding_vec{comp}.png",
                title=f"{name} embedding (colored by eigenvector {comp})")
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "k_nn": k_nn, "n_eigs": n_eigs, "eps_scale": eps_scale,
            "sigma_construct": sigma_c, "sigma_mandel": sigma_m})
    return {"vals_construct": vals_c, "vals_mandel": vals_m,
            "sigma_construct": sigma_c, "sigma_mandel": sigma_m,
            "spectral_distance": dist}


def run_symmetry(c_aligned, m_pts, matches=None, tol=0.05, out_prefix=None,
                 scan_dtype=None):
    """Symmetry op table + best axis (symmetry_phase_bestaxis.py)."""
    rows, best = sym.symmetry_report(c_aligned, m_pts, matches, tol,
                                     scan_dtype=scan_dtype)
    if out_prefix:
        writers.write_dict_rows_csv(f"{out_prefix}_symmetry_report_bestaxis.csv", rows)
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "tol": tol, "n_construct": len(np.asarray(c_aligned)),
            "n_mandel": len(np.asarray(m_pts))})
    return {"rows": rows, "best": best}


@dataclass
class TCIConfig:
    construct_ns: tuple = tuple(range(20, 301, 20))
    mandelbrot_grid: int = 600
    mandelbrot_samples: int = 25000
    escape_r: float = 250.0
    max_iter: int = 250
    grid_bins: int = 128
    domain: tuple = (-2.25, 1.25, -1.75, 1.75)
    alpha: float = 0.2
    t_steps: int = 60
    eps: float = 1e-12
    sinkhorn_eps: float = 0.8
    curvature_k: int = 6
    spectral_k: int = 30
    spectral_sigma: float = 0.05
    seed: int = 7
    cloud_backend: str = "aberth"
    # "pallas" runs the DE grid + quantile band + Gumbel-top-k subsample on
    # the f32 Pallas head (O(n_samples) host transfer) — the fast path for the
    # BASELINE configs[4] 4x-grid run. "jax"/"numpy" are the f64 host paths.
    de_impl: str = "jax"


def run_tci(cfg: TCIConfig, out_json: str | None = None):
    """The v002_fixed main pipeline (tci_construct_mandelbrot_v002_fixed.py:120-170)."""
    import time

    import jax.numpy as jnp

    from cmtci.kernels import companion, mandelbrot as mb

    t0 = time.time()
    rng = np.random.RandomState(cfg.seed)
    c_pts = companion.inverse_cloud(list(cfg.construct_ns), backend=cfg.cloud_backend)
    m_pts = mb.sample_boundary_quantile(cfg.domain, cfg.mandelbrot_grid,
                                        cfg.mandelbrot_samples, cfg.max_iter,
                                        cfg.escape_r, cfg.eps, rng,
                                        impl=cfg.de_impl,
                                        dtype=jnp.float32 if cfg.de_impl == "pallas"
                                        else jnp.float64)
    m_match, c_trim = entropic_argmax_match(
        c_pts, m_pts, cfg.sinkhorn_eps, rng,
        dtype=np.float32 if cfg.de_impl == "pallas" else None)
    c_aligned = procrustes_align_no_scale(c_trim, m_match, convention="reference")

    # defensive metrics like the reference (tci_..._v002_fixed.py:129-145:
    # failures fall back to NaN; its spectral distance over the FULL 25000-pt
    # cloud MemoryErrors on typical machines, so large clouds yield NaN
    # deterministically here instead of grinding on a 25000² eigensolve)
    try:
        n = min(len(c_aligned), len(m_pts))
        c_sub = rng.choice(c_aligned, n, replace=False)
        m_sub = rng.choice(m_pts, n, replace=False)
        h0 = ps.hausdorff(c_sub, m_sub)
        ecc_dt = jnp.float32 if cfg.de_impl == "pallas" else None
        curv_corr = float(np.corrcoef(
            curv.pca_eccentricity(c_sub, cfg.curvature_k, dtype=ecc_dt),
            curv.pca_eccentricity(m_sub, cfg.curvature_k, dtype=ecc_dt),
        )[0, 1])
    except Exception:
        h0, curv_corr = float("nan"), float("nan")
    try:
        if max(len(c_aligned), len(m_pts)) > 8000:
            raise MemoryError("dense kernel spectrum would exceed memory")
        dspec = sp.spectral_distance(c_aligned, m_pts, cfg.spectral_k, cfg.spectral_sigma)
    except Exception:
        dspec = float("nan")

    p_m = np.asarray(hg.to_prob(m_pts, cfg.grid_bins, cfg.domain, cfg.eps))
    x_c = np.asarray(hg.to_prob(c_aligned, cfg.grid_bins, cfg.domain, cfg.eps))
    kls, traj = giflow.tci_flow(p_m, x_c, cfg.alpha, cfg.t_steps, cfg.eps)

    out = {
        "Hausdorff_before": float(h0),
        "Curvature_corr": curv_corr,
        "Spectral_L2": float(dspec),
        "KL_initial": float(kls[0]),
        "KL_final": float(kls[-1]),
        "runtime_sec": time.time() - t0,
    }
    if out_json:
        writers.write_json(out_json, out)
        from cmtci.io import plots

        prefix = out_json.rsplit(".", 1)[0]
        plots.plot_kl_descent(kls, f"{prefix}_KL_descent.png")
        plots.plot_field(traj[-1], cfg.domain, f"{prefix}_XT_final.png",
                         title="Final histogram X_T")
        writers.write_config_meta(f"{prefix}_meta.txt", cfg)
    return out, kls, traj


def run_spatial_stats(c_aligned, m_pts, r_max=1.5, dr=0.05, out_prefix=None,
                      stat_dtype=None, mesh=None):
    """phase2 + phase3: g(r), Ripley K, Hausdorff, gradient curvature, box dim.

    stat_dtype=jnp.float32 runs the three O(n²) pair scans (shell counts
    per cloud + Hausdorff) on the default device — counts exact
    int32, borderline f32 bin flips possible; the host f64 pass is the
    stage wall at beyond-reference bus sizes. With `mesh` the shell counts
    shard over the mesh; either way the (hi, lo) int32 carry-spill keeps
    counts exact with no pair-count ceiling."""
    shells_c = ps._shell_counts(c_aligned, r_max, dr, dtype=stat_dtype,
                                mesh=mesh)
    shells_m = ps._shell_counts(m_pts, r_max, dr, dtype=stat_dtype, mesh=mesh)
    r_c, g_c = ps.pair_correlation(c_aligned, r_max, dr, _shells=shells_c)
    r_m, g_m = ps.pair_correlation(m_pts, r_max, dr, _shells=shells_m)
    _, k_c = ps.ripley_k(c_aligned, r_max, dr, _shells=shells_c)
    _, k_m = ps.ripley_k(m_pts, r_max, dr, _shells=shells_m)
    out = {
        "r": r_c, "g_construct": g_c, "g_mandel": g_m,
        "K_construct": k_c, "K_mandel": k_m,
        "hausdorff": ps.hausdorff(c_aligned, m_pts, dtype=stat_dtype),
        "curv_construct": curv.gradient_curvature(np.asarray(c_aligned)),
        "curv_mandel": curv.gradient_curvature(np.asarray(m_pts)),
    }
    fd_c, _ = ps.fractal_dimension(c_aligned)
    fd_m, _ = ps.fractal_dimension(m_pts)
    out["fractal_dim_construct"] = fd_c
    out["fractal_dim_mandel"] = fd_m
    if out_prefix:
        writers.write_dict_rows_csv(f"{out_prefix}_spatial_stats.csv", [{
            "hausdorff": out["hausdorff"],
            "fractal_dim_construct": fd_c, "fractal_dim_mandel": fd_m,
        }])
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "r_max": r_max, "dr": dr, "n_construct": len(np.asarray(c_aligned)),
            "n_mandel": len(np.asarray(m_pts))})
        from cmtci.io import plots

        plots.plot_curvature_hotspots(
            c_aligned, m_pts, out["curv_construct"], out["curv_mandel"],
            f"{out_prefix}_curvature_hotspots.png")
    return out


def run_report(c, m, c_aligned, matches, out_prefix=None):
    """phase5 integrative summary (phase5_report.py:190-217 schema)."""
    row = {"n_construct": len(c), "n_mandel": len(m), "n_aligned": len(c_aligned)}
    match_d = None
    if matches is not None and len(matches):
        ln = min(len(matches), len(c_aligned), len(m))
        match_d = np.linalg.norm(np.asarray(c_aligned)[:ln] - np.asarray(m)[np.asarray(matches)[:ln]], axis=1)
        d = match_d
        row.update(match_min=float(d.min()), match_median=float(np.median(d)),
                   match_mean=float(d.mean()), match_max=float(d.max()),
                   match_std=float(d.std()))
    row["hausdorff"] = ps.hausdorff(c_aligned, m)
    for pts, name in ((c_aligned, "construct"), (m, "mandel")):
        k = curv.gradient_curvature(np.asarray(pts))
        k = k[np.isfinite(k)]
        row[f"curv_{name}_median"] = float(np.median(k))
        row[f"curv_{name}_mean"] = float(np.mean(k))
        fd, _ = ps.fractal_dimension(pts)
        row[f"fractal_dim_{name}"] = float(fd)
    if out_prefix:
        writers.write_dict_rows_csv(f"{out_prefix}_phase5_summary.csv", [row])
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "n_construct": len(c), "n_mandel": len(m), "n_aligned": len(c_aligned)})
        from cmtci.io import plots

        plots.plot_alignment(c, m, c_aligned, f"{out_prefix}_matching_visualization.png",
                             title="Initial matching visualization")
        if match_d is not None:
            plots.plot_match_distance_hist(match_d,
                                           f"{out_prefix}_match_distance_hist.png")
    return row
