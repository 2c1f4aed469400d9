"""cmtci benchmark on the GPU: one JSON line per measurement.

Every line names the device it ran on (JAX's platform, device_kind and
device count) and the card's name and power limit as nvidia-smi reports
them; without a GPU the script exits non-zero and measures nothing.

  * escape_grid_res2000_mi500 — escape-time grid throughput (Mpix/s) of
    the Pallas dwell head on BASELINE config #1 (res=2000, max_iter=500,
    domain (-2.1,0.9)x(-1.5,1.5) — the reference's
    mandelbrot_boundary_sample.py hot loop), one grid per timed call.
    Baseline: the reference's pure-Python per-pixel dwell loop on a CPU
    (every-16th-pixel subsample, identical escape statistics): 0.0158 Mpix/s.
  * escape_grid_res{4096,8192}, spatial_stats_150k, knn_150k — scale keys.
  * eigensweep — warm wall time of the full inverse-eigenvalue cloud at
    the tracker's stage-4 shape (ns = 20..1220 step 20, Σn = 37,820 roots;
    lucas_equipotential_test_v3.py:93-118). Baseline: 44.6 s for the same
    sweep via np.linalg.eigvals on a CPU (VALIDATION.md).
  * tracker_warm — the 4-stage dense Appendix-A tracker
    (gi_assumption_tracker_v3.py, bins 64→512, oracle growth schedule) on
    the f32 Pallas DE head + f32 matcher. Baseline: 287.1 s total on the
    reference author's CPU (v3_T25_sigma3_dense.csv).
  * equipotential, variograms, uniformize_green, uniformize_fem, tci_4x,
    coupling — the pipelines at their reference configs on the GPU-session
    defaults, against the CPU wall times below.
"""

import json
import sys
import time

import numpy as np

REFERENCE_CPU_MPIX_S = 0.0158   # measured; see module docstring
REFERENCE_LAPACK_EIG_S = 44.6   # np.linalg.eigvals on a CPU (VALIDATION.md)
REFERENCE_TRACKER_S = 287.1     # v3_T25_sigma3_dense.csv runtime_sec sum
REFERENCE_EQUIPOTENTIAL_S = 312.0  # reference script wall time on a CPU
REFERENCE_VARIOGRAMS_S = 71.0   # this repo's f64 CPU path (the reference caps
#                                 pairs per bin, so its numbers aren't comparable)
REFERENCE_GREEN_S = 29.0        # this repo's f64 CPU uniformize-green at the
#                                 v40 config (n_bdy=2000, 20000 interior)
REFERENCE_FEM_S = 6.8           # this repo's f64 CPU v18 4-level study (the
#                                 reference v18 script publishes no runtime)
REFERENCE_TCI_4X_S = 64.3       # this repo's f64 CPU TCI pipeline at BASELINE
#                                 configs[4]: 2400^2 DE grid (4x), 25000
#                                 samples, T=60
REFERENCE_COUPLING_S = 13.2     # this repo's f64 CPU coupling pipeline at the
#                                 default stage1 bus (819-pt cloud, 300² grid,
#                                 4 iterations)

DOM = (-2.1, 0.9, -1.5, 1.5)
RES = 2000
MAX_ITER = 500

STAGE4_NS = list(range(20, 1221, 20))


def _best(fn, reps: int = 3) -> float:
    """Best wall time of `reps` calls after one warm-up (compile) call; fn
    must block until its device work is done."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _grid_mpix_s(res: int) -> float:
    """Mpix/s of the Pallas dwell head on a res x res grid, max_iter=500."""
    from cmtci.kernels.mandelbrot_pallas import mandelbrot_field_pallas

    t = _best(lambda: mandelbrot_field_pallas(DOM, res, res, max_iter=MAX_ITER)
              .block_until_ready())
    return res * res / t / 1e6


def _bench_scale() -> dict:
    """Scale-demonstration keys — the reference's res=2000 is the floor,
    not the ceiling:

      * escape_grid_res{4096,8192}_mpix_s — the Pallas dwell head at 4x/16x
        the reference pixel count;
      * spatial_stats_150k_s — TWO 150k-point f32 shell-count pair scans
        (2.25e10 pairs each; exact counts via the (hi,lo) int32 carry
        spill) + the f32 Hausdorff;
      * knn_150k_s — the embeddings kNN search (k=20, hi/lo two-float
        coordinates + host exact re-rank) at 150k points.
    """
    import jax.numpy as jnp

    out = {f"escape_grid_res{res}_mpix_s": _grid_mpix_s(res)
           for res in (4096, 8192)}

    rng = np.random.default_rng(1)
    t = rng.uniform(0, 2 * np.pi, 150_000)
    r = 1.0 + 0.05 * rng.standard_normal(150_000)
    c1 = np.column_stack([r * np.cos(t), r * np.sin(t)])
    c2 = c1[::-1] + 0.01 * rng.standard_normal((150_000, 2))

    from cmtci.stats import pointstats as ps

    def scan():
        sh1 = ps._shell_counts(c1, 0.5, 0.02, dtype=jnp.float32)
        sh2 = ps._shell_counts(c2, 0.5, 0.02, dtype=jnp.float32)
        h = ps.hausdorff(c1, c2, dtype=jnp.float32)
        assert sh1[1].sum() > 0 and sh2[1].sum() > 0 and h > 0
        return h

    out["spatial_stats_150k_s"] = _best(scan, reps=2)

    from cmtci.stats.embeddings import build_sparse_kernel

    def knn():
        kmat, sigma = build_sparse_kernel(c1, k=20, dtype=jnp.float32)
        assert kmat.shape == (150_000, 150_000) and sigma > 0

    out["knn_150k_s"] = _best(knn, reps=2)
    return out


def _bench_eigensweep() -> float:
    """Warm wall time of the stage-4 inverse cloud."""
    from cmtci.kernels import companion

    def sweep():
        assert companion.inverse_cloud(STAGE4_NS).shape[0] == sum(STAGE4_NS)

    return _best(sweep)


def _bench_tracker() -> float:
    """Warm wall time of the dense tracker (oracle growth params)."""
    from cmtci.pipelines.tracker import TrackerConfig, run_tracker

    cfg = TrackerConfig(
        sigma_bins=3.0, t_fixed=25,  # the dense-oracle config
        bins_start=64, bins_max=512,
        construct_max_start=300, construct_max_growth=1.6,
        mandelbrot_samples_growth=1.6, mandelbrot_samples_max=300000,
        field_dtype="float32", de_impl="pallas",
    )

    def run():
        assert len(run_tracker(cfg)[0]) == 4

    return _best(run)


def _bench_equipotential() -> float:
    """Warm wall time of the full equipotential pipeline (f32 cloud head)."""
    from cmtci.pipelines.equipotential import (EquipotentialConfig,
                                               run_equipotential)

    cfg = EquipotentialConfig(potential_dtype="float32")

    def run():
        out = run_equipotential(cfg)
        assert 0.5 < out["summary"]["escaped_frac"] < 1.0

    return _best(run)


def _bench_variograms() -> float:
    """Warm wall time of the full variogram pipeline (f32 binning)."""
    from cmtci.pipelines.variograms import VariogramConfig, run_variograms

    cfg = VariogramConfig(vario_dtype="float32", field_dtype="float32")

    def run():
        out = run_variograms(cfg)
        assert np.isfinite(out["gamma_construct"][1:]).all()

    return _best(run)


def _bench_uniformize_green() -> float:
    """Warm wall time of the full v40 Riemann-map pipeline (f32 maps)."""
    from cmtci.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary
    from cmtci.pipelines.uniformize_green import (GreenUniformizeConfig,
                                                  run_green_uniformization)

    pts = export_lucas_boundary(LucasBoundaryConfig())  # input, not timed
    cfg = GreenUniformizeConfig(map_dtype="float32")

    def run():
        out = run_green_uniformization(pts, cfg)
        assert 0.99 < out["diagnostics"]["bdy_mod_median"] < 1.01

    return _best(run)


def _bench_uniformize_fem() -> float:
    """Warm wall time of the v18 FEM quasiconformal study, all 4 levels, on
    the GPU-session solver default (the fused on-device θ-iteration); the
    warm reps reuse the memoized meshes (_mesh_bundle), as a parameter
    sweep would."""
    from cmtci.pipelines.uniformize_fem import (FEMUniformizeConfig,
                                                run_fem_uniformization)

    def run():
        res = run_fem_uniformization(FEMUniformizeConfig())
        assert len(res) == 4
        assert res[-1]["all"]["K_median"] < res[0]["all"]["K_median"]

    return _best(run, reps=2)


def _bench_tci_4x() -> float:
    """Warm wall time of the TCI/GI-flow pipeline at 4x grid resolution
    (BASELINE configs[4]: 2400^2 DE grid, 25000 samples, T=60)."""
    from cmtci.pipelines.analysis import TCIConfig, run_tci

    cfg = TCIConfig(mandelbrot_grid=2400, de_impl="pallas")

    def run():
        out, kls, _ = run_tci(cfg)
        assert kls[-1] < kls[0] and out["KL_final"] < 1e-5

    return _best(run)


def _bench_coupling() -> float:
    """Warm wall time of the iterative variogram<->Laplacian coupling (P5)
    on the f32 device-field path (default stage1 bus; bus build not timed)."""
    from cmtci.pipelines.coupling import CouplingConfig, run_coupling
    from cmtci.pipelines.stage1 import Stage1Config, run_stage1

    bus = run_stage1(Stage1Config())  # input, not timed
    cfg = CouplingConfig(field_dtype="float32")

    def run():
        rows, _ = run_coupling(bus["C"], bus["M"], bus["matches"], cfg)
        assert len(rows) == cfg.n_iter and np.isfinite(rows[-1]["corr_pot"])

    return _best(run)


#: (key, function, unit, CPU baseline in the same unit or None)
CELLS = (
    ("escape_grid_res2000_mi500_mpix_s", lambda: _grid_mpix_s(RES), "Mpix/s",
     REFERENCE_CPU_MPIX_S),
    ("scale", _bench_scale, "s / Mpix/s", None),
    ("eigensweep_s", _bench_eigensweep, "s", REFERENCE_LAPACK_EIG_S),
    ("tracker_warm_s", _bench_tracker, "s", REFERENCE_TRACKER_S),
    ("equipotential_s", _bench_equipotential, "s", REFERENCE_EQUIPOTENTIAL_S),
    ("variograms_s", _bench_variograms, "s", REFERENCE_VARIOGRAMS_S),
    ("uniformize_green_s", _bench_uniformize_green, "s", REFERENCE_GREEN_S),
    ("uniformize_fem_s", _bench_uniformize_fem, "s", REFERENCE_FEM_S),
    ("tci_4x_s", _bench_tci_4x, "s", REFERENCE_TCI_4X_S),
    ("coupling_s", _bench_coupling, "s", REFERENCE_COUPLING_S),
)


def main() -> int:
    import jax

    import cmtci  # noqa: F401  (enables x64; the kernel paths set f32 locally)
    from cmtci.utils.device import gpu_card

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 1
    device = {"platform": devices[0].platform, "kind": devices[0].device_kind,
              "count": len(devices), "card": gpu_card()}
    failed = 0
    for key, fn, unit, baseline in CELLS:
        line = {"key": key, "unit": unit, "device": device}
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001 — recorded, and fails the run
            line["error"] = repr(e)[:300]
            failed += 1
        else:
            line["value"] = value
            if baseline is not None:
                line["vs_cpu_baseline"] = (value / baseline if unit == "Mpix/s"
                                           else baseline / value)
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
