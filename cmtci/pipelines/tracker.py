"""GI assumption tracker (Appendix A verification) — reference orchestrator P4.

Rebuild of gi_assumption_tracker_v3.py:155-343 as a config-driven library
call (the reference dynamically imports tci_construct_mandelbrot_v002_fixed
and monkey-patches its globals; here everything is explicit parameters).

Per resolution (bins doubling 64 -> bins_max):
  1. Construct cloud C (inverse eigenvalues, ns = step..construct_max)
  2. Mandelbrot boundary proxy M (TCI DE grid + 25%-quantile sampler)
  3. kernel-argmax OT match + Procrustes (reference rotation convention)
  4. mollified histograms P_M, P_C (sigma in bins)
  5. GI-flow (fixed-T or adaptive-to-threshold), delta_n = KL(P_M||X_T)
  6. TV / overlap / Pinsker / compound diagnostics; growth schedule
     (gi_assumption_tracker_v3.py:296-299)

With parity=True the RNG stream (np.random.RandomState(seed)), LAPACK cloud
ordering, and scipy-cdist matcher reproduce the checked-in
v3_T25_sigma3_dense / v3_adaptive artifacts; the default path runs the same
math with the batched Aberth eigensolver and blocked on-device matcher.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from cmtci.kernels import companion, mandelbrot
from cmtci.transport import giflow
from cmtci.transport import histogram as hg
from cmtci.transport.procrustes import procrustes_align_no_scale
from cmtci.transport.sinkhorn import entropic_argmax_match
from cmtci.utils import artifacts
from cmtci.utils.artifacts import StageTimer


@dataclass
class TrackerConfig:
    # tracker CLI knobs (gi_assumption_tracker_v3.py:156-188 defaults)
    seed: int = 7
    domain: tuple = (-2.2, 1.2, -1.6, 1.6)
    alpha: float = 0.1
    bins_start: int = 64
    bins_max: int = 1024
    construct_step: int = 20
    construct_max_start: int = 300
    construct_max_growth: float = 1.35
    mandelbrot_grid_start: int = 600
    mandelbrot_grid_growth: float = 1.15
    mandelbrot_samples_start: int = 25000
    mandelbrot_samples_growth: float = 1.35
    mandelbrot_samples_max: int = 150000
    sigma_bins: float = 1.0
    t_fixed: int = -1
    kl_threshold: float = 1e-6
    max_steps: int = 800
    min_steps: int = 5
    compound_threshold: float = 1e-3
    tv_threshold: float = 0.05
    # TCI module constants (tci_construct_mandelbrot_v002_fixed.py:12-22)
    escape_r: float = 250.0
    max_iter: int = 250
    sinkhorn_eps: float = 0.8
    eps: float = 1e-12
    # execution
    parity: bool = False  # LAPACK cloud + scipy matcher for bitwise oracle runs
    family: str = "lucas_all_ones"
    field_dtype: str = "float64"  # "float32" for the device fast path (f32
    # changes the DE overflow threshold but the escaped&overflowed selection
    # is statistically unchanged)
    de_impl: str = "jax"  # "pallas" for the fused early-exit DE head
    # (kernels/mandelbrot_pallas.py tci kind); parity mode forces "numpy"


@dataclass
class TrackerRow:
    # field names/order mirror the reference Row (gi_assumption_tracker_v3.py:48-81)
    bins: int
    mesh_proxy: float
    construct_max_n: int
    construct_step: int
    n_construct_pts: int
    mandelbrot_grid: int
    mandelbrot_samples: int
    n_mandel_pts: int
    alpha: float
    sigma_bins: float
    mode: str
    T_n: int
    kl_initial: float
    delta_n: float
    kl_PM_PC: float
    pinsker_tv_bound_XT_PM: float
    tv_XT_PM: float
    tv_PC_PM: float
    overlap_mass_PC_PM: float
    mass_outside_domain_C: float
    mass_outside_domain_M: float
    tv_bound_PC_PM: float
    compound: float
    compound_with_pinsker: float
    stop_reason: str
    runtime_sec: float


def run_tracker(cfg: TrackerConfig, max_stages: Optional[int] = None, mesh=None,
                cache_dir: Optional[str] = None, timer: Optional[StageTimer] = None):
    """Run the resolution-doubling tracker. Returns (rows, meta).

    With a `jax.sharding.Mesh`, the stage's heavy device work runs sharded
    over it — DE grid rows, the O(n·m) kernel-argmax matcher, and the
    histogram scatter-adds (parallel/sharded.py) — with bitwise-identical
    results to the single-device path (host RNG / quantile / Procrustes are
    unchanged); parity=True ignores the mesh (host-numpy oracle path).

    With `cache_dir`, each stage's kernel products (aligned clouds) and the
    post-stage RNG state are stored keyed by the stage config (SURVEY §5.4 —
    the reference resumes at file-bus granularity, e.g. the
    lucas_points.npy skip at lucas_to_cardioid_v18...py:1070-1077); reruns
    with identical parameters touch no eigensolve/DE/matcher kernel and the
    shared RNG stream continues exactly where the stage left it. A
    `StageTimer` records per-phase wall times (SURVEY §5.1).
    """
    rng = np.random.RandomState(cfg.seed)
    timer = timer if timer is not None else StageTimer()
    rows: List[TrackerRow] = []
    bins = int(cfg.bins_start)
    construct_max = int(cfg.construct_max_start)
    grid = int(cfg.mandelbrot_grid_start)
    samples = int(cfg.mandelbrot_samples_start)
    global_stop = ""
    cloud_backend = "lapack" if cfg.parity else "aberth"
    matcher_backend = "numpy" if cfg.parity else "jax"

    # The per-stage cloud schedule is fully determined by the config (the
    # cloud never consumes the shared RNG stream — invariant pinned in
    # tests/test_tracker_regression.py), so on the fast path ALL stage
    # eigensweeps start on one background worker immediately: stage k's
    # host Aberth sweep overlaps stage k-1's matcher/histograms/GI-flow,
    # not just its own device DE sample. Stage 4 (n<=1220, ~0.19 s) was
    # the warm floor's largest term.
    cloud_futures: dict = {}
    cloud_ex = None
    if cfg.de_impl == "pallas" and not cfg.parity and cache_dir is None:
        from concurrent.futures import ThreadPoolExecutor

        cloud_ex = ThreadPoolExecutor(1)
        b_pre, cm_pre, n_pre = bins, construct_max, 0
        while b_pre <= int(cfg.bins_max) and (max_stages is None or n_pre < max_stages):
            # a non-growing schedule (growth ~1.0 rounds back to the same
            # construct_max) must not enqueue duplicate sweeps: they would
            # serialize on the 1-worker executor in front of stage 1's
            # result() while later stages find the key already consumed
            if cm_pre not in cloud_futures:
                ns_pre = list(range(cfg.construct_step, cm_pre + 1, cfg.construct_step))
                cloud_futures[cm_pre] = cloud_ex.submit(
                    companion.inverse_cloud, ns_pre, cfg.family, tol=1e-10,
                    backend=cloud_backend)
            b_pre *= 2
            cm_pre = int(round((cm_pre * cfg.construct_max_growth)
                               / cfg.construct_step)) * cfg.construct_step
            n_pre += 1

    try:
        while bins <= int(cfg.bins_max):
            if max_stages is not None and len(rows) >= max_stages:
                break
            t0 = time.time()
            ns = list(range(cfg.construct_step, construct_max + 1, cfg.construct_step))

            stage_mesh = None if cfg.parity else mesh
            stage_cfg = {**{k: v for k, v in dataclasses.asdict(cfg).items()},
                         "stage_bins": bins, "construct_max": construct_max,
                         "grid": grid, "samples": samples, "n_stage": len(rows)}

            def _stage_kernels():
                def _cloud():
                    # get, not pop: stages sharing one construct_max (non-
                    # growing schedules) reuse the same precomputed cloud
                    fut = cloud_futures.get(construct_max)
                    if fut is not None:
                        return fut.result()
                    return companion.inverse_cloud(ns, cfg.family, tol=1e-10,
                                                   backend=cloud_backend)

                def _sample():
                    return mandelbrot.sample_boundary_quantile(
                        cfg.domain, grid, samples, max_iter=cfg.max_iter, escape_r=cfg.escape_r,
                        eps=cfg.eps, rng=rng, impl="numpy" if cfg.parity else cfg.de_impl,
                        dtype=jnp.float32 if cfg.field_dtype == "float32" else jnp.float64,
                        mesh=stage_mesh,
                    )

                if cfg.de_impl == "pallas" and not cfg.parity:
                    # the eigensweep (Aberth) and the DE sample (Pallas head)
                    # are independent until the matcher — overlap them. The
                    # shared RNG stream is untouched by the cloud, so the
                    # realization is identical to the sequential order.
                    from concurrent.futures import ThreadPoolExecutor

                    with timer.stage(f"bins{bins}_cloud+sample"):
                        with ThreadPoolExecutor(1) as ex:
                            fut = ex.submit(_cloud)
                            m_cloud = _sample()
                            c_cloud = fut.result()
                else:
                    with timer.stage(f"bins{bins}_cloud"):
                        c_cloud = _cloud()
                    with timer.stage(f"bins{bins}_sample"):
                        m_cloud = _sample()
                with timer.stage(f"bins{bins}_match"):
                    m_match, c_sub = entropic_argmax_match(
                        c_cloud, m_cloud, eps=cfg.sinkhorn_eps, rng=rng,
                        backend=matcher_backend, mesh=stage_mesh,
                        dtype=np.float32 if (cfg.field_dtype == "float32"
                                             and not cfg.parity) else None,
                    )
                c_aligned = procrustes_align_no_scale(c_sub, m_match, convention="reference")
                return {"c_aligned": c_aligned, "m_aligned": m_match,
                        **artifacts.rng_state_arrays(rng)}

            stage_out = artifacts.cached("tracker_stage", stage_cfg, _stage_kernels,
                                         cache_dir=cache_dir or ".cmtci_cache",
                                         enabled=cache_dir is not None)
            artifacts.restore_rng_state(rng, stage_out)
            c_aligned = np.asarray(stage_out["c_aligned"])
            m_aligned = np.asarray(stage_out["m_aligned"])

            outside_c = hg.fraction_outside_domain(c_aligned, cfg.domain)
            outside_m = hg.fraction_outside_domain(m_aligned, cfg.domain)

            hist_np = cfg.de_impl == "pallas" and not cfg.parity and stage_mesh is None
            with timer.stage(f"bins{bins}_hist"):
                p_m = np.asarray(hg.mollified_histogram(m_aligned, bins, cfg.domain, cfg.sigma_bins, cfg.eps, mesh=stage_mesh, host_numpy=hist_np))
                p_c = np.asarray(hg.mollified_histogram(c_aligned, bins, cfg.domain, cfg.sigma_bins, cfg.eps, mesh=stage_mesh, host_numpy=hist_np))
            kl_pm_pc = hg.kl(p_m, p_c, cfg.eps)

            with timer.stage(f"bins{bins}_giflow"):
                if cfg.t_fixed > 0:
                    mode = f"fixedT={cfg.t_fixed}"
                    x_t, t_n, kl0, delta = giflow.gi_flow_fixed_t(
                        p_m, p_c, cfg.alpha, cfg.t_fixed, cfg.eps,
                        host_numpy=hist_np)
                    stop_reason = "fixed_T"
                else:
                    mode = "adaptive"
                    x_t, t_n, kl0, delta = giflow.gi_flow_to_threshold(
                        p_m, p_c, cfg.alpha, cfg.kl_threshold, cfg.max_steps, cfg.min_steps, cfg.eps,
                        host_numpy=hist_np and bins <= 128,
                    )
                    stop_reason = (
                        "kl_threshold_met" if delta <= cfg.kl_threshold else "max_steps_reached"
                    )

            tv_xt_pm = hg.tv_distance(x_t, p_m)
            tv_pc_pm = hg.tv_distance(p_c, p_m)
            ov = hg.overlap_mass(p_c, p_m)
            pinsker = hg.pinsker_bound(delta)
            factor = (1.0 - cfg.alpha) ** (-int(t_n)) if t_n > 0 else float("inf")

            rows.append(TrackerRow(
                bins=bins,
                mesh_proxy=1.0 / bins,
                construct_max_n=construct_max,
                construct_step=cfg.construct_step,
                n_construct_pts=int(c_aligned.size),
                mandelbrot_grid=grid,
                mandelbrot_samples=samples,
                n_mandel_pts=int(m_aligned.size),
                alpha=cfg.alpha,
                sigma_bins=cfg.sigma_bins,
                mode=mode,
                T_n=int(t_n),
                kl_initial=float(kl0),
                delta_n=float(delta),
                kl_PM_PC=float(kl_pm_pc),
                pinsker_tv_bound_XT_PM=float(pinsker),
                tv_XT_PM=float(tv_xt_pm),
                tv_PC_PM=float(tv_pc_pm),
                overlap_mass_PC_PM=float(ov),
                mass_outside_domain_C=float(outside_c),
                mass_outside_domain_M=float(outside_m),
                tv_bound_PC_PM=float(factor * pinsker),
                compound=float(factor * np.sqrt(delta)),
                compound_with_pinsker=float(factor * pinsker),
                stop_reason=stop_reason,
                runtime_sec=float(time.time() - t0),
            ))

            if (delta <= cfg.kl_threshold and rows[-1].compound <= cfg.compound_threshold
                    and tv_pc_pm <= cfg.tv_threshold):
                global_stop = ("global_stop: kl<=threshold AND compound<=threshold "
                               "AND TV(P_C,P_M)<=tv_threshold")
                break

            bins *= 2
            construct_max = int(round((construct_max * cfg.construct_max_growth) / cfg.construct_step)) * cfg.construct_step
            grid = int(round(grid * cfg.mandelbrot_grid_growth))
            samples = min(cfg.mandelbrot_samples_max, int(round(samples * cfg.mandelbrot_samples_growth)))

    finally:
        # a stage that raises (no-escape-points, ...) must
        # not leak the precompute executor: Python's atexit hook would
        # otherwise drain every still-queued Aberth sweep before the
        # process can exit
        if cloud_ex is not None:
            cloud_ex.shutdown(wait=False, cancel_futures=True)
    meta = {
        **{k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(cfg).items()},
        "global_stop_reason": global_stop,
        "stage_times": dict(timer.times),
        "stage_bytes": dict(timer.bytes),  # all jax fetches per phase
        "stage_accel_bytes": dict(timer.accel_bytes),  # accelerator fetches only
        "rows": [dataclasses.asdict(r) for r in rows],
    }
    return rows, meta


def write_outputs(rows, meta, out_prefix: str):
    """CSV + JSON writers, schema-compatible with the reference outputs."""
    import csv as _csv

    from cmtci.io.writers import ensure_dir

    ensure_dir(f"{out_prefix}.csv")
    csv_path = f"{out_prefix}.csv"
    json_path = f"{out_prefix}.json"
    if rows:
        with open(csv_path, "w", newline="", encoding="utf-8") as f:
            w = _csv.DictWriter(f, fieldnames=list(dataclasses.asdict(rows[0]).keys()))
            w.writeheader()
            for r in rows:
                w.writerow(dataclasses.asdict(r))
    else:
        open(csv_path, "w", encoding="utf-8").close()
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    from cmtci.io import writers

    writers.write_config_meta(f"{out_prefix}_meta.txt",
                              {k: v for k, v in meta.items()
                               if k not in ("rows", "stage_times", "stage_bytes",
                                            "stage_accel_bytes")})
    return csv_path, json_path
