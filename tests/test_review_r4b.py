"""Regressions for the round-4 geometry/maps/io/utils review findings."""

import json
import os
import threading

import numpy as np

from cmtci.geometry import alpha_shape
from cmtci.geometry.cardioid import cardioid_polygon
from cmtci.geometry.polygon import Polygon
from cmtci.io import writers
from cmtci.maps import fem
from cmtci.utils.artifacts import cached


def test_json_nonfinite_numpy_scalars_are_valid_json(tmp_path):
    """np.floating NaN/Inf must not reach json.dump as bare tokens."""
    obj = {"nan": np.float64("nan"), "inf": np.float32("inf"),
           "ninf": np.float64("-inf"), "ok": np.float64(2.0)}
    p = writers.write_json(str(tmp_path / "x.json"), obj)
    raw = open(p).read()
    # strict parse: bare NaN/Infinity tokens would raise here
    back = json.loads(raw, parse_constant=lambda s: (_ for _ in ()).throw(
        ValueError(f"bare non-finite token {s!r} in output")))
    assert back["nan"] == "nan"
    assert back["inf"] == "inf"
    assert back["ninf"] == "-inf"
    assert back["ok"] == 2.0


def test_cached_concurrent_miss_publishes_intact_npz(tmp_path):
    """Concurrent misses on one key must each write a private tmp file."""
    cache = str(tmp_path / "c")
    data = np.arange(20000, dtype=np.float64)
    barrier = threading.Barrier(4)
    results, errors = [], []

    def worker():
        try:
            barrier.wait()
            out = cached("stage", {"k": 1}, lambda: {"a": data},
                         cache_dir=cache)
            results.append(out["a"])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 4
    for r in results:
        np.testing.assert_array_equal(r, data)
    # the published file must load cleanly and no tmp debris may remain
    out2 = cached("stage", {"k": 1}, lambda: {"a": data * 0}, cache_dir=cache)
    np.testing.assert_array_equal(out2["a"], data)  # hit, not recompute
    assert not [f for f in os.listdir(cache) if f.endswith(".tmp")]


def test_unwrap_theta_anchor_is_respected():
    rng = np.random.default_rng(0)
    theta = np.unwrap(np.sort(rng.uniform(-np.pi, np.pi, 64)))
    wrapped = np.angle(np.exp(1j * theta))
    for k in (0, 17, 63):
        out = fem.unwrap_theta(wrapped, anchor_index=k)
        assert abs(out[k] - wrapped[k]) < 1e-12, (k, out[k], wrapped[k])
        # still an unwrap: no jumps beyond pi between neighbors
        assert np.max(np.abs(np.diff(out))) < np.pi
    # anchor 0 keeps the historical behavior exactly
    np.testing.assert_allclose(fem.unwrap_theta(wrapped, 0),
                               np.unwrap(wrapped), atol=0)


def test_polygon_keeps_distinct_near_closing_vertex():
    # a ring whose last vertex is genuinely distinct but within allclose's
    # old rtol=1e-5 of the first: must be KEPT now
    t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
    ring = np.column_stack([np.cos(t), np.sin(t)])
    ring = np.vstack([ring, ring[0] + [3e-6, 0.0]])
    assert len(Polygon(ring).xy) == 401
    # exact duplicate closing vertex is still dropped
    closed = np.vstack([ring[:-1], ring[0]])
    assert len(Polygon(closed).xy) == 400
    # parametric trig closure (~1e-16 noise) is still absorbed
    assert len(cardioid_polygon(101, endpoint=True).xy) == 100


def test_trace_boundary_matches_per_component_rescan(rng=None):
    """The one-pass component dispatch must reproduce the old per-component
    edge_set rescan bitwise (same adjacency insertion order)."""
    from collections import defaultdict

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(400, 2))
    edges = alpha_shape.alpha_shape_edges(pts, alpha=3.0)
    assert len(edges) > 0
    ordered, was_closed = alpha_shape.trace_boundary(pts, edges)

    # old formulation, verbatim
    comps, _ = alpha_shape._components(edges)
    edge_set = {tuple(e) for e in np.asarray(edges).tolist()}
    closed, open_ = [], []
    for comp in comps:
        local = defaultdict(list)
        for i, j in edge_set:
            if i in comp:
                local[i].append(j)
                local[j].append(i)
        o, is_c = alpha_shape._trace(local, comp)
        if len(o) < 5:
            continue
        (closed if is_c else open_).append(o)
    expect = (max(closed, key=len), True) if closed else (max(open_, key=len), False)
    assert (ordered, was_closed) == expect


def test_cg_solve_agrees_with_spsolve():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(120, 2))
    from scipy.spatial import Delaunay

    tri = Delaunay(pts).simplices
    k = fem.assemble_stiffness(pts, tri)
    bnd = alpha_shape.boundary_edges_of(tri)
    bnd = np.unique(bnd)
    g = np.cos(np.arange(len(bnd)) * 0.3)
    u_lu = fem.dirichlet_solve(k, bnd, g, method="spsolve")
    u_cg = fem.dirichlet_solve(k, bnd, g, method="cg")
    np.testing.assert_allclose(u_cg, u_lu, atol=1e-7)


# --- pipelines/cli review batch ---------------------------------------------


def test_stage1_empty_band_raises_clear_error():
    import pytest

    from cmtci.pipelines.stage1 import Stage1Config, run_stage1

    with pytest.raises(ValueError, match="no boundary points in the DE band"):
        run_stage1(Stage1Config(max_n=8, nx=40, ny=30,
                                threshold_low=0.5, threshold_high=0.4))


def test_coupling_requires_matches():
    import pytest

    from cmtci.pipelines.coupling import CouplingConfig, run_coupling

    c = np.zeros((5, 2))
    with pytest.raises(ValueError, match="matches_indices.csv"):
        run_coupling(c, c, None, CouplingConfig(n_iter=1, grid_res=16))


def test_cli_domain_field_count():
    import pytest

    from cmtci.cli import main

    with pytest.raises(SystemExit, match="xmin:xmax:ymin:ymax"):
        main(["tracker", "--domain=-2.2:1.2:-1.6", "--t-fixed", "1",
              "--bins-start", "16", "--bins-max", "16", "--out", "/tmp/_x"])


def test_tracker_nongrowing_schedule_single_eigensweep(monkeypatch, tmp_path):
    """growth=1.0 repeats construct_max; the precompute must submit ONE
    sweep and every stage must reuse it (no inline recompute)."""
    from cmtci.kernels import companion
    from cmtci.pipelines.tracker import TrackerConfig, run_tracker

    calls = []
    real = companion.inverse_cloud

    def counting(ns, *a, **k):
        calls.append(tuple(ns))
        return real(ns, *a, **k)

    monkeypatch.setattr(companion, "inverse_cloud", counting)
    rows, _ = run_tracker(TrackerConfig(
        bins_start=16, bins_max=32, construct_max_start=60,
        construct_max_growth=1.0, t_fixed=2,
        mandelbrot_grid_start=64, mandelbrot_grid_growth=1.0,
        mandelbrot_samples_start=200, mandelbrot_samples_growth=1.0,
        field_dtype="float32", de_impl="pallas"))
    assert len(rows) == 2
    assert len(calls) == 1, calls  # one precompute, zero inline recomputes


def test_green_fit_cache_ignores_sampling_knobs(tmp_path):
    """interior_n / do_inverse_check changes must HIT the cached fit."""
    from dataclasses import replace

    from cmtci.pipelines.uniformize_green import (GreenUniformizeConfig,
                                                  run_green_uniformization)
    from cmtci.geometry.cardioid import cardioid_polygon

    pts = cardioid_polygon(400, endpoint=False).xy
    cache = str(tmp_path / "cache")
    cfg = GreenUniformizeConfig(n_bdy=150, interior_n=400, alpha=8.0,
                                do_inverse_check=False,
                                polygon_source="ordered")
    run_green_uniformization(pts, cfg, cache_dir=cache)
    fits0 = [f for f in os.listdir(cache) if f.startswith("riemann_fit")]
    run_green_uniformization(pts, replace(cfg, interior_n=600,
                                          do_inverse_check=True),
                             cache_dir=cache)
    fits1 = [f for f in os.listdir(cache) if f.startswith("riemann_fit")]
    assert fits0 == fits1  # same single cached fit, no second entry
    # a fit-affecting knob DOES miss
    run_green_uniformization(pts, replace(cfg, n_bdy=160), cache_dir=cache)
    fits2 = [f for f in os.listdir(cache) if f.startswith("riemann_fit")]
    assert len(fits2) == len(fits1) + 1


def test_construct_boundary_short_warns():
    import pytest

    from cmtci.pipelines.lucas_boundary import (ConstructBoundaryConfig,
                                                construct_boundary)

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 2))
    with pytest.warns(UserWarning, match="min_points"):
        construct_boundary(pts, ConstructBoundaryConfig(alpha=2.0,
                                                        target_n=300,
                                                        min_points=10_000))


# --- kernels/parallel review batch -------------------------------------------


def test_analysis_step_mesh_independent_nonmultiple_lanes():
    """90 flat root lanes on an 8-device mesh: the old flat[:88] truncation
    dropped 2 valid n=30 roots, making kl mesh-size dependent."""
    from cmtci.parallel import sharded

    ns = [10, 20, 30]
    domain = (-2.25, 1.25, -1.75, 1.75)
    out = {}
    for nd in (1, 8):
        d = sharded.analysis_step(ns, domain, grid_n=48, bins=16,
                                  max_iter=40, mesh=sharded.device_mesh(nd))
        out[nd] = {k: float(v) for k, v in d.items()}
    assert out[1]["n_roots"] == out[8]["n_roots"] == sum(ns)
    assert out[1]["escaped_frac"] == out[8]["escaped_frac"]
    assert abs(out[1]["kl"] - out[8]["kl"]) < 1e-5


def test_sharded_eigensweep_sparser_pad_rows_exact():
    """Pad rows now carry deg=2 for the sparser family (deg=1 is outside the
    closed form's eligibility); real-row roots equal the unsharded sweep."""
    from cmtci.kernels import companion
    from cmtci.parallel import sharded

    fam = "sparser_gap_1_0_1_then_ones"
    ns = [3, 4, 5, 6, 7, 8]  # 6 rows on a 4-device mesh -> 2 pad rows
    zr_s, zi_s, v_s = sharded.sharded_eigensweep(ns, fam,
                                                 mesh=sharded.device_mesh(4))
    zr_b, zi_b, v_b = companion.eigvals_batched(ns, fam)
    np.testing.assert_array_equal(np.asarray(v_s), np.asarray(v_b))
    np.testing.assert_allclose(np.asarray(zr_s)[np.asarray(v_s)],
                               np.asarray(zr_b)[np.asarray(v_b)], atol=1e-12)
    np.testing.assert_allclose(np.asarray(zi_s)[np.asarray(v_s)],
                               np.asarray(zi_b)[np.asarray(v_b)], atol=1e-12)
    # the pad configuration itself converges quickly under the closed form
    import jax.numpy as jnp

    a, deg = companion.poly_coeff_batch([5, 6], fam)
    a2 = jnp.pad(a, ((0, 2), (0, 0)))
    a2 = a2.at[2:, 0].set(1.0)
    d2 = jnp.concatenate([deg, jnp.full(2, 2, deg.dtype)])
    _, _, _, iters, done = companion.aberth_roots(a2, d2, family=fam,
                                                  return_info=True)
    assert bool(done) and int(iters) < 40, (int(iters), bool(done))


def test_tracker_train_step_rejects_oversized_n_samples():
    import jax
    import pytest

    from cmtci.parallel.sharded import device_mesh, tracker_train_step

    mesh = device_mesh(2)
    ns = [4, 8]  # 16 root lanes total < n_samples
    with pytest.raises(ValueError, match="exceeds the pixel"):
        tracker_train_step(mesh, ns, (-2.25, 1.25, -1.75, 1.75), grid_n=16,
                           n_samples=64, bins=8, key=jax.random.key(0),
                           max_iter=16)


def test_sharded_de_tci_field_grid_passthrough():
    import jax.numpy as jnp

    from cmtci.kernels import mandelbrot as mb
    from cmtci.parallel import sharded

    domain = (-2.25, 1.25, -1.75, 1.75)
    mesh = sharded.device_mesh(4)
    esc0, d0 = sharded.sharded_de_tci_field(domain, 32, mesh, max_iter=30)
    cr, ci = mb.complex_grid(domain, 32, 32, dtype=jnp.float64)
    esc1, d1 = sharded.sharded_de_tci_field(domain, 32, mesh, max_iter=30,
                                            grid=(cr, ci))
    np.testing.assert_array_equal(esc0, esc1)
    np.testing.assert_array_equal(d0, d1)


def test_dryrun_xla_flags_count_upgrade(monkeypatch):
    """A preset smaller device count must be rewritten, not left as-is."""
    import subprocess
    import sys

    code = (
        "import os; os.environ['XLA_FLAGS']="
        "'--xla_force_host_platform_device_count=2'\n"
        "import sys; sys.path.insert(0, %r)\n"
        "from __graft_entry__ import dryrun_multichip\n"
        "dryrun_multichip(4)\n" % os.path.join(os.path.dirname(__file__), "..")
    )
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[dryrun_multichip] n=4" in out.stdout


def test_coupling_f32_field_dtype_trajectory_bitwise():
    """field_dtype='float32' moves only the potential DIAGNOSTICS to f32:
    the nudge trajectory (dists/variogram/weights are host f64 either way)
    and every d_* row must be bitwise identical; corr diagnostics close."""
    from cmtci.pipelines.coupling import CouplingConfig, run_coupling

    rng = np.random.default_rng(5)
    t = rng.uniform(0, 2 * np.pi, 300)
    c = np.column_stack([0.4 * np.cos(t), 0.4 * np.sin(t)])
    m = np.column_stack([0.5 * np.cos(t), 0.5 * np.sin(t)]) + 0.01
    matches = np.arange(300)
    base = dict(n_iter=2, grid_res=80, max_iter_mb=60, win_local_corr=6)
    rows64, c64 = run_coupling(c, m, matches, CouplingConfig(**base))
    rows32, c32 = run_coupling(c, m, matches,
                               CouplingConfig(**base, field_dtype="float32"))
    np.testing.assert_array_equal(c64, c32)
    for r64, r32 in zip(rows64, rows32):
        for k in ("d_mean", "d_median", "d_max", "vario_range_a", "sigma_px"):
            assert r64[k] == r32[k] or (np.isnan(r64[k]) and np.isnan(r32[k]))
        assert abs(r64["corr_pot"] - r32["corr_pot"]) < 1e-4
        assert abs(r64["corr_lap"] - r32["corr_lap"]) < 5e-3


def test_coupling_f32_artifacts_match_f64_frames(tmp_path):
    """The f32 artifact path reconstructs the full-frame local-correlation
    map (NaN border + device interior) and the smoothed/U_M frames from
    device-resident arrays; they must line up with the host-f64 artifacts
    frame-for-frame (same NaN support, values within f32 diagnostics
    tolerance) and the per-iteration variogram CSVs must be bitwise."""
    from cmtci.pipelines.coupling import CouplingConfig, run_coupling

    rng = np.random.default_rng(11)
    t = rng.uniform(0, 2 * np.pi, 250)
    c = np.column_stack([0.4 * np.cos(t), 0.4 * np.sin(t)])
    m = np.column_stack([0.5 * np.cos(t), 0.5 * np.sin(t)]) + 0.01
    matches = np.arange(250)
    base = dict(n_iter=2, grid_res=72, max_iter_mb=60, win_local_corr=6)
    p64 = str(tmp_path / "c64")
    p32 = str(tmp_path / "c32")
    run_coupling(c, m, matches, CouplingConfig(**base), out_prefix=p64)
    run_coupling(c, m, matches, CouplingConfig(**base, field_dtype="float32"),
                 out_prefix=p32)
    for it in (1, 2):
        l64 = np.load(f"{p64}_{it}_localcorr.npy")
        l32 = np.load(f"{p32}_{it}_localcorr.npy")
        assert l64.shape == l32.shape
        # the NaN supports agree except at degenerate windows (the n>5 &
        # denom>0 gate flips when a near-constant window's variance sits at
        # f32 rounding scale); the border frame itself must be identical
        n64, n32 = np.isnan(l64), np.isnan(l32)
        w = 6
        assert n64[:w].all() and n64[-w:].all() and n32[:w].all() and n32[-w:].all()
        assert (n64 != n32).mean() < 0.08
        ok = ~(n64 | n32)
        assert ok.sum() > 0.3 * l64.size
        assert np.nanmax(np.abs(l64[ok] - l32[ok])) < 5e-2
        # high-agreement summary (pointwise f32 local corr is noisier in
        # near-degenerate windows; the map as a whole must track)
        assert np.corrcoef(l64[ok], l32[ok])[0, 1] > 0.999
        v64 = open(f"{p64}_{it}_variogram_construct.csv").read()
        v32 = open(f"{p32}_{it}_variogram_construct.csv").read()
        assert v64 == v32  # host-f64 nudge stream: bitwise


def test_suite_accel_guard_falls_back_to_host(tmp_path, capsys, monkeypatch):
    """A device-head size guard (ValueError) in one accel stage must not
    abort the suite: the stage reruns on the host path and the remaining
    stages still execute (cli.py suite fallback; the 65536-point int32
    guard is exercised directly in test_shell_counts_signed_int32_guard —
    here a monkeypatched stage stands in so the test stays small)."""
    from cmtci import cli

    out = str(tmp_path)
    assert cli.main(["stage1", "--max-n", "12", "--boundary-samples", "80",
                     "--out", f"{out}/bus"]) == 0
    real = cli._run_bus_stage

    def fake(st, c, m, ca, matches, out_prefix, opts, mesh=None):
        if st == "spatial-stats" and opts:
            raise ValueError("synthetic size-guard rejection")
        return real(st, c, m, ca, matches, out_prefix, opts, mesh=mesh)

    monkeypatch.setattr(cli, "_run_bus_stage", fake)
    capsys.readouterr()
    assert cli.main(["suite", "--busdir", f"{out}/bus",
                     "--stages", "spatial-stats,report",
                     "--device", "accel", "--out", f"{out}/suite"]) == 0
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert "hausdorff" in line  # the stage completed on the host path
    assert "rerunning this stage on the host path" in cap.err
    assert os.path.exists(f"{out}/suite/spatial-stats_spatial_stats.csv")


def test_coupling_fused_dispatch_grouping():
    """n_iter past the fuse cap (8) spans two fused dispatches; the
    cross-group concatenation must keep every iteration's corr rows
    aligned with the host-f64 realization (and the trajectory bitwise)."""
    from cmtci.pipelines.coupling import CouplingConfig, run_coupling

    rng = np.random.default_rng(3)
    t = rng.uniform(0, 2 * np.pi, 150)
    c = np.column_stack([0.35 * np.cos(t), 0.35 * np.sin(t)])
    m = np.column_stack([0.5 * np.cos(t), 0.5 * np.sin(t)]) + 0.01
    matches = np.arange(150)
    base = dict(n_iter=10, grid_res=48, max_iter_mb=40, win_local_corr=4)
    rows64, c64 = run_coupling(c, m, matches, CouplingConfig(**base))
    rows32, c32 = run_coupling(c, m, matches,
                               CouplingConfig(**base, field_dtype="float32"))
    np.testing.assert_array_equal(c64, c32)
    assert len(rows32) == 10
    for r64, r32 in zip(rows64, rows32):
        assert np.isfinite(r32["corr_pot"])  # every NaN placeholder filled
        assert abs(r64["corr_pot"] - r32["corr_pot"]) < 1e-4
        assert abs(r64["corr_lap"] - r32["corr_lap"]) < 5e-3
