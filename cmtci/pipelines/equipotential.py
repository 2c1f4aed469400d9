"""Green-function statistics pipeline (P3, call stack SURVEY §3.5).

Reference: lucas_equipotential_test_v3.py:363-448 — aggregate cloud g_M
stats, reference-law comparison, per-n and cumulative convergence rows,
4-family comparison.

Device-first: batch_potential's per-point scalar loop (the reference's hot
path at :153-162) is the batched green_potential kernel; the cumulative
stats (quadratic total work in the reference, :310-327) reuse per-n g
values — mathematically identical because g is a per-point quantity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci.io import writers
from cmtci.kernels import companion, mandelbrot as mb
from cmtci.stats import laws


@dataclass
class EquipotentialConfig:
    n_min: int = 2
    n_max: int = 200
    max_iter: int = 20000
    escape_radius: float = 2.0
    eig_tol: float = 1e-12
    families: tuple = (
        "lucas_all_ones",
        "pell_like_all_twos",
        "sparser_gap_1_0_1_then_ones",
        "padovan_like_0_1_then_ones",
    )
    run_family_comparison: bool = True
    cloud_backend: str = "aberth"
    potential_dtype: str = "float64"  # "float32" = the f32 Pallas cloud-green
    # head (kernels/mandelbrot_pallas.green_cloud_f32): identical escape
    # set / k on measured clouds, g rel err ~1e-7 median (deep escapers
    # carry chaotic f32 trajectory noise at negligible absolute size)
    # optional stored-curve analysis (lucas_equipotential_test_v3.py:390-403):
    # path to an .npy of boundary points ((N,2) xy or complex); its Green
    # potential is summarized, law-compared, and saved as g_curve.npy
    curve_npy: str | None = None


def batch_potential(cloud: np.ndarray, max_iter: int, escape_radius: float,
                    cache_dir: str | None = None, dtype: str = "float64",
                    mesh=None):
    """(g, it, phi) for a complex cloud via the compaction-staged Green kernel.

    Exactly equal to the plain batched kernel per point (verified), ~125x
    faster at the reference's max_iter=20000 because escaped points are
    dropped between stages instead of riding along for the interior's full
    iteration budget. With cache_dir the result is stored keyed by
    (cloud digest, max_iter, R, dtype) — SURVEY §5.4 resume.
    dtype="float32" runs the f32 Pallas head on the default device. With `mesh`
    (f64 path) each compaction stage's active batch is point-sharded over
    the mesh (parallel.sharded.green_stage_executor — bitwise equal).
    """
    from cmtci.utils import artifacts

    def _run():
        if dtype == "float32":
            from cmtci.kernels.mandelbrot_pallas import green_cloud_f32

            g, it, phi = green_cloud_f32(cloud, max_iter=max_iter,
                                         escape_r=escape_radius)
        else:
            executor = None
            if mesh is not None:
                from cmtci.parallel.sharded import green_stage_executor

                executor = green_stage_executor(mesh)
            g, it, phi = mb.green_potential_compacted(
                cloud, max_iter=max_iter, escape_r=escape_radius,
                stage_executor=executor)
        return {"g": g, "it": it, "phi": phi}

    out = artifacts.cached(
        "green_potential",
        {"cloud": artifacts.array_digest(cloud), "max_iter": max_iter,
         "escape_r": escape_radius,
         **({"dtype": dtype} if dtype != "float64" else {})},
        _run, cache_dir=cache_dir or ".cmtci_cache", enabled=cache_dir is not None,
    )
    return np.asarray(out["g"]), np.asarray(out["it"]), np.asarray(out["phi"])


def _per_n_potentials(cfg: EquipotentialConfig, family: str | None = None,
                      cache_dir: str | None = None, clouds=None, g=None):
    """g for every n's inverse-eigenvalue cloud in ONE batched solve.

    The reference recomputes the potential per n (and per cumulative prefix,
    O(N²) total work, lucas_equipotential_test_v3.py:294-327); g is a
    per-point quantity, so one padded batch suffices. Returns list of
    (n, g_array). Pass `clouds` (inverse_cloud_split output) and the
    matching flat `g` to reuse a solve already done — run_equipotential's
    main cloud IS this split's concatenation, so no second eigensolve or
    potential kernel runs at all.
    """
    fam = family or "lucas_all_ones"
    ns = list(range(cfg.n_min, cfg.n_max + 1))
    if clouds is None:
        clouds = companion.inverse_cloud_split(ns, fam, tol=cfg.eig_tol,
                                               backend=cfg.cloud_backend)
    if g is None:
        g, _, _ = batch_potential(np.concatenate(clouds), cfg.max_iter,
                                  cfg.escape_radius, cache_dir=cache_dir,
                                  dtype=cfg.potential_dtype)
    out = []
    off = 0
    for n, c in zip(ns, clouds):
        out.append((n, g[off : off + len(c)]))
        off += len(c)
    return out


def per_n_stats(cfg: EquipotentialConfig, family: str | None = None,
                per_n_g=None):
    """Per-n escaped fraction and g stats (lucas_equipotential_test_v3.py:294-308)."""
    per_n_g = per_n_g or _per_n_potentials(cfg, family)
    return [{"n": n, **laws.summarize_outside(g[g > 0], len(g))}
            for n, g in per_n_g]


def cumulative_stats(cfg: EquipotentialConfig, family: str | None = None,
                     per_n_g=None):
    """Cumulative-N rows (:310-327) from the same single batched solve."""
    per_n_g = per_n_g or _per_n_potentials(cfg, family)
    # the concatenation of the per-n list up to n IS the prefix of the full
    # flat concatenation, and extraction preserves order — so the escaped
    # values of every prefix are prefixes of ONE global escaped extraction.
    # summarize_g re-masked each prefix (five boolean gathers of up to the
    # full array per row); this extracts
    # once and hands each row its slice, value-identical per row.
    g_flat = np.concatenate([g for _, g in per_n_g])
    esc = g_flat[g_flat > 0]
    rows = []
    off = 0
    m = 0
    for n, g in per_n_g:
        off += len(g)
        m += int(np.count_nonzero(g > 0))
        rows.append({"N": n, **laws.summarize_outside(esc[:m], off)})
    return rows


def run_equipotential(cfg: EquipotentialConfig, out_dir: str | None = None,
                      with_per_n: bool = True, cache_dir: str | None = None,
                      timer=None, mesh=None):
    """Full driver. Returns dict of results; writes CSV/NPY if out_dir."""
    from cmtci.utils.artifacts import StageTimer

    timer = timer if timer is not None else StageTimer()
    c_curve = None
    if cfg.curve_npy is not None:
        # load (and so validate) the stored curve BEFORE the expensive
        # stages: a typo'd path must fail in milliseconds, not after the
        # whole potential solve and before any output is written (the
        # reference warns-and-skips, lucas_equipotential_test_v3.py:404-405;
        # here a missing input is a typed error at the pipeline edge)
        pts = np.load(cfg.curve_npy)
        if pts.ndim == 2 and pts.shape[1] == 2:
            c_curve = pts[:, 0] + 1j * pts[:, 1]
        else:
            c_curve = np.asarray(pts, dtype=complex).ravel()
    ns = list(range(cfg.n_min, cfg.n_max + 1))
    others = ([f for f in cfg.families if f != "lucas_all_ones"]
              if cfg.run_family_comparison else [])
    with timer.stage("cloud"):
        # all four family eigensweeps are cheap host-XLA Aberth calls now
        # that threshold-spanning sweeps bucket (companion._bucketing_pays:
        # ~0.04 s each vs 0.20 s single-batch) — the round-3 worker-thread
        # overlap machinery bought nothing once the sweeps stopped
        # dominating, so the clouds are just computed inline
        clouds = companion.inverse_cloud_split(ns, "lucas_all_ones",
                                               tol=cfg.eig_tol,
                                               backend=cfg.cloud_backend)
        c_inv = np.concatenate(clouds)
        fam_clouds = [companion.inverse_cloud(ns, f, tol=cfg.eig_tol,
                                              backend=cfg.cloud_backend)
                      for f in others]
    with timer.stage("potential"):
        # ONE device solve for lucas + the other families: g is a per-point
        # quantity, so batch composition cannot change it (the same reason
        # the per-n split can reuse this solve) — one dispatch replaces
        # the round-3 two-solve structure
        all_pts = (np.concatenate([c_inv, *fam_clouds]) if fam_clouds
                   else c_inv)
        g_all, it_all, phi_all = batch_potential(
            all_pts, cfg.max_iter, cfg.escape_radius, cache_dir=cache_dir,
            dtype=cfg.potential_dtype, mesh=mesh)
        g, it, phi = (g_all[: len(c_inv)], it_all[: len(c_inv)],
                      phi_all[: len(c_inv)])
    out = {
        "summary": laws.summarize_g(g),
        "laws": laws.compare_reference_laws(g[g > 0]),
    }
    if with_per_n:
        with timer.stage("per_n"):
            # per-n/cumulative stats reuse the main solve (clouds' concat IS
            # c_inv, so the g split is exact) — no extra kernel runs
            per_n_g = _per_n_potentials(cfg, clouds=clouds, g=g)
            out["per_n"] = per_n_stats(cfg, per_n_g=per_n_g)
            out["cumulative"] = cumulative_stats(cfg, per_n_g=per_n_g)
    fam_g = None
    if cfg.run_family_comparison:
        with timer.stage("families"):
            fam_g = {"lucas_all_ones": g}
            off = len(c_inv)
            for f, c in zip(others, fam_clouds):
                fam_g[f] = g_all[off : off + len(c)]
                off += len(c)
            fam_rows = []
            for fam in cfg.families:
                s = laws.summarize_g(fam_g[fam])
                s["family"] = fam
                fam_rows.append(s)
            out["family_summary"] = fam_rows
    if c_curve is not None:
        with timer.stage("stored_curve"):
            # optional stored-curve analysis (reference section C,
            # lucas_equipotential_test_v3.py:390-403): Green potential of a
            # saved boundary polyline, e.g. lucas_points.npy
            g_c, _, _ = batch_potential(c_curve, cfg.max_iter,
                                        cfg.escape_radius, cache_dir=cache_dir,
                                        dtype=cfg.potential_dtype, mesh=mesh)
            out["curve_summary"] = laws.summarize_g(g_c)
            out["curve_laws"] = laws.compare_reference_laws(g_c[g_c > 0])
            out["curve_g"] = g_c
    out["stage_times"] = dict(timer.times)
    if out_dir:
        writers.write_config_meta(f"{out_dir}/meta.txt", cfg,
                                  extra={"n_cloud": len(c_inv)})
        np.save(f"{out_dir}/C_lucas.npy", c_inv)
        np.save(f"{out_dir}/g_lucas.npy", g)
        np.save(f"{out_dir}/it_lucas.npy", it)
        np.save(f"{out_dir}/phi_lucas.npy", phi)
        if with_per_n:
            writers.write_dict_rows_csv(f"{out_dir}/per_n_stats.csv", out["per_n"])
            writers.write_dict_rows_csv(f"{out_dir}/cumulative_stats.csv", out["cumulative"])
        if cfg.run_family_comparison:
            writers.write_dict_rows_csv(f"{out_dir}/family_summary.csv", out["family_summary"])
        from cmtci.io import plots

        # density figures (lucas_equipotential_test_v3.py:251-288,417-446)
        if out["laws"] is not None:
            plots.plot_g_density_compare(out["laws"], g[g > 0],
                                         f"{out_dir}/equipotential")
        if fam_g is not None:
            plots.plot_family_kde_overlay(fam_g,
                                          f"{out_dir}/family_kde_overlay.png")
        if "curve_g" in out:
            np.save(f"{out_dir}/g_curve.npy", out["curve_g"])
            if out["curve_laws"] is not None:
                plots.plot_g_density_compare(
                    out["curve_laws"], out["curve_g"][out["curve_g"] > 0],
                    f"{out_dir}/lucas_curve")
    return out
