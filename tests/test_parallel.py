"""Multi-chip sharding on the 8-device virtual CPU mesh."""

import numpy as np

import jax
import jax.numpy as jnp

from cmtci.kernels import companion
from cmtci.kernels import mandelbrot as mb
from cmtci.parallel import sharded
from cmtci.transport import histogram as hg

DOMAIN = (-2.25, 1.25, -1.75, 1.75)


def test_mesh_has_8_devices():
    mesh = sharded.device_mesh()
    assert mesh.devices.size == 8


def test_sharded_dwell_matches_single_device():
    mesh = sharded.device_mesh()
    got = np.asarray(sharded.sharded_dwell_grid(DOMAIN, 64, 64, 50, mesh))
    cr, ci = mb.complex_grid(DOMAIN, 64, 64, dtype=jnp.float32)
    ref = np.asarray(mb.dwell_grid(np.asarray(cr), np.asarray(ci), max_iter=50))
    assert (got == ref).mean() > 0.99


def test_sharded_eigensweep_matches_lapack():
    ns = [5, 8, 11, 14, 17, 20, 23, 26, 29, 32]  # 10 polys over 8 devices
    zr, zi, valid = sharded.sharded_eigensweep(ns)
    z = np.asarray(zr) + 1j * np.asarray(zi)
    from scipy.optimize import linear_sum_assignment

    for b, n in enumerate(ns):
        ref = np.linalg.eigvals(companion.companion_matrix(companion.family_top_row("lucas_all_ones", n)))
        got = z[b][np.asarray(valid)[b]]
        cost = np.abs(got[:, None] - ref[None, :])
        r, c = linear_sum_assignment(cost)
        assert cost[r, c].max() < 1e-8


def test_sharded_histogram_matches_numpy(rng):
    mesh = sharded.device_mesh()
    x = rng.uniform(-3, 2, 4096)
    y = rng.uniform(-2, 2, 4096)
    got = np.asarray(sharded.sharded_histogram(jnp.asarray(x), jnp.asarray(y), 32, DOMAIN, mesh))
    ref = np.asarray(hg.histogram2d(x, y, 32, DOMAIN))
    np.testing.assert_array_equal(got, ref)


def test_sharded_semivariogram_matches_single_device(rng):
    from cmtci.stats import variogram as vg

    mesh = sharded.device_mesh()
    gx, gy = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    f = rng.normal(size=(16, 16))
    r_bins = np.linspace(0, 0.9, 10)
    # single-device reference with no subsampling (m_target = all points)
    coords = np.column_stack([gx.ravel(), gy.ravel()])
    _, g_ref, c_ref = vg.grid_semivariogram(f, gx, gy, r_bins, m_target=256,
                                            rng=np.random.RandomState(0))
    g, c = sharded.sharded_semivariogram(coords, f.ravel(), r_bins, mesh, chunk=16)
    np.testing.assert_array_equal(c, c_ref)
    np.testing.assert_allclose(g, g_ref, rtol=1e-12)


def test_dryrun_multichip_entrypoint():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # single-chip jittable forward step
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out["dwell"].shape == (256, 256)
    assert float(out["hist"].sum()) > 0
    # full multi-chip dry run on the virtual mesh
    mod.dryrun_multichip(8)


def test_dryrun_multichip_hermetic_subprocess():
    """MULTICHIP_r02 regression: the dry run must pin the platform itself.

    r02 failed because dryrun_multichip only fell back to CPU devices for
    the mesh — eager ops still initialized the environment's default
    accelerator client, which crashed before any sharded math ran.
    Conftest's jax_platforms=cpu pin masked this from the in-process test,
    so this one runs in a clean subprocess WITHOUT the pin and WITHOUT the
    driver's XLA_FLAGS: dryrun must pin the CPU platform and provision the
    virtual devices entirely on its own.
    """
    import os
    import subprocess
    import sys

    path = os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    code = (
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('graft_entry', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "mod.dryrun_multichip(8)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[dryrun_multichip] n=8" in out.stdout
    # VERDICT r3 item 4a: the dry run is deterministic given
    # jax.random.key(0), so pin the exact diagnostics — kl0 silently drifted
    # 5.16 -> 4.9979 between r2 and r3 (the Gumbel sample-fetch change) and
    # only the loose invariants noticed nothing. Any sharding-semantics or
    # sampler change must now update these on purpose.
    import re

    m = re.search(r"kl0=([\d.]+) delta=([\d.]+) tv=([\d.]+) escaped_px=(\d+)",
                  out.stdout)
    assert m, out.stdout
    kl0, delta, tv = float(m[1]), float(m[2]), float(m[3])
    assert int(m[4]) == 14194
    assert abs(kl0 - 4.9978795052) < 1e-7, kl0
    assert abs(delta - 0.3343999982) < 1e-7, delta
    assert abs(tv - 0.3663094044) < 1e-7, tv


import pytest


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_mesh_sizes_odd_shapes_bitwise(n_dev, rng):
    """VERDICT r2 item 8: mesh-size sweep with non-divisible shapes.

    Odd grid rows (101), prime point counts (997) and prime matcher rows
    (193) across 2/4/8-device meshes must equal single-device bitwise
    (padding + psum order are engineered for exactness).
    """
    from cmtci.transport import histogram as hg
    from cmtci.transport.sinkhorn import _argmax_kernel_rows, _blocked_mean_dist

    mesh = sharded.device_mesh(n_dev)

    # row-sharded DE grid, odd size
    esc_s, d_s = sharded.sharded_de_tci_field(DOMAIN, 101, mesh, max_iter=40)
    cr, ci = mb.complex_grid(DOMAIN, 101, 101)
    esc, d, _, _ = mb.de_field_tci(cr, ci, max_iter=40)
    np.testing.assert_array_equal(esc_s, np.asarray(esc))
    np.testing.assert_array_equal(d_s, np.asarray(d))

    # point-sharded histogram, prime count
    x = rng.uniform(-3, 2, 997)
    y = rng.uniform(-2, 2, 997)
    got = np.asarray(hg.mollified_histogram(x + 1j * y, 16, DOMAIN, 2.0, mesh=mesh))
    ref = np.asarray(hg.mollified_histogram(x + 1j * y, 16, DOMAIN, 2.0))
    np.testing.assert_array_equal(got, ref)

    # row-sharded matcher, prime rows over small chunks
    a = rng.normal(size=(193, 2))
    b = rng.normal(size=(89, 2))
    import jax.numpy as jnp
    mean = _blocked_mean_dist(jnp.asarray(a), jnp.asarray(b))
    ref_m = np.asarray(_argmax_kernel_rows(jnp.asarray(a), jnp.asarray(b), mean, 0.8))
    got_m = sharded.sharded_argmax_match(a, b, 0.8, mesh, chunk=16)
    np.testing.assert_array_equal(got_m, ref_m[:193])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_tracker_stage_small_mesh_bitwise(n_dev):
    """The REAL tracker stage at odd grid / prime samples == single-device."""
    import dataclasses

    from cmtci.pipelines.tracker import TrackerConfig, run_tracker

    mesh = sharded.device_mesh(n_dev)
    cfg = TrackerConfig(bins_start=16, bins_max=16, construct_max_start=60,
                        mandelbrot_grid_start=101, mandelbrot_samples_start=397,
                        max_iter=50, sigma_bins=2.0, t_fixed=4)
    rows_1, _ = run_tracker(cfg, max_stages=1)
    rows_m, _ = run_tracker(cfg, max_stages=1, mesh=mesh)
    d1 = dataclasses.asdict(rows_1[0])
    dm = dataclasses.asdict(rows_m[0])
    for k, v in d1.items():
        if k != "runtime_sec":
            assert dm[k] == v, (k, dm[k], v)


@pytest.mark.slow
@pytest.mark.parametrize("n_dev", [16, 32])
def test_dryrun_multichip_large_mesh(n_dev):
    """VERDICT r2 item 8: the driver dry run survives 16/32-device meshes
    (fresh subprocess; dryrun provisions its own virtual devices)."""
    import os
    import subprocess
    import sys

    path = os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    code = (
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('graft_entry', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"mod.dryrun_multichip({n_dev})\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"[dryrun_multichip] n={n_dev}" in out.stdout


@pytest.mark.parametrize("n_dev", [2, 8])
def test_analysis_step_runs_on_mesh(n_dev):
    """The full sharded analysis step (eigensweep -> cloud histogram ->
    dwell grid -> escape-proxy histogram -> GI-flow) compiles and executes
    over the mesh, and its diagnostics agree across mesh sizes (psum
    reduction order may differ, so KL matches to tolerance while the
    root/escape counts are exact)."""
    ns = [5, 8, 11, 14, 17, 20, 23, 26]
    out = {}
    for nd in (1, n_dev):
        mesh = sharded.device_mesh(nd)
        d = sharded.analysis_step(ns, DOMAIN, grid_n=48, bins=16,
                                  max_iter=40, mesh=mesh)
        out[nd] = {k: float(v) for k, v in d.items()}
    ref, got = out[1], out[n_dev]
    assert got["n_roots"] == ref["n_roots"] == sum(ns)
    assert got["escaped_frac"] == ref["escaped_frac"]
    assert 0.0 < got["escaped_frac"] < 1.0
    assert np.isfinite(got["kl"]) and got["kl"] > 0
    assert abs(got["kl"] - ref["kl"]) < 1e-5


def test_sharded_shell_counts_matches_single_device(rng):
    """The mesh head must agree with BOTH single-device heads bin for bin
    (same masked_bin_reduce kernel at equal dtype), and its `_shells`
    tuple must drop into pair_correlation/ripley_k unchanged."""
    from cmtci.stats import pointstats as ps

    mesh = sharded.device_mesh()
    pts = rng.uniform(size=(919, 2))  # odd size: pad rows cross devices
    r64, c64, n64, rho64 = ps._shell_counts(pts, 0.5, 0.05)
    for n_dev, chunk in ((8, 64), (4, 128), (2, 64)):
        m = sharded.device_mesh(n_dev)
        rs, cs, ns_, rhos = sharded.sharded_shell_counts(pts, 0.5, 0.05, m,
                                                         chunk=chunk)
        np.testing.assert_array_equal(rs, r64)
        np.testing.assert_array_equal(cs, c64)  # f64 vs f64: bitwise
        assert (ns_, rhos) == (n64, rho64)
    # f32 partials == the single-device f32 masked head exactly
    _, c32, _, _ = ps._shell_counts(pts, 0.5, 0.05, dtype=jnp.float32)
    _, cs32, _, _ = sharded.sharded_shell_counts(pts, 0.5, 0.05, mesh,
                                                 chunk=64, dtype=jnp.float32)
    np.testing.assert_array_equal(cs32, c32)
    # the tuple IS a drop-in for the stats wrappers
    sh = sharded.sharded_shell_counts(pts, 0.4, 0.04, mesh, chunk=64)
    rv, g_mesh = ps.pair_correlation(pts, 0.4, 0.04, _shells=sh)
    _, g_one = ps.pair_correlation(pts, 0.4, 0.04)
    np.testing.assert_allclose(g_mesh, g_one, rtol=1e-12)
    _, k_mesh = ps.ripley_k(pts, 0.4, 0.04, _shells=sh)
    _, k_one = ps.ripley_k(pts, 0.4, 0.04)
    np.testing.assert_allclose(k_mesh, k_one, rtol=1e-12)


def test_hilo_accumulator_exact_past_int32():
    """The (hi, lo) int32 carry-spill accumulator that removed the
    65536-point pair-count ceiling must stay exact far past 2^31 total."""
    from cmtci.stats.pointstats import _hilo_spill, _hilo_total

    add = jnp.asarray([2**30, 123, 1], jnp.int32)

    def body(_, acc):
        hi, lo = acc
        return _hilo_spill(hi, lo + add)

    hi, lo = jax.lax.fori_loop(
        0, 5000, body,
        (jnp.zeros(3, jnp.int32), jnp.zeros(3, jnp.int32)))
    want = 5000 * np.asarray([2**30, 123, 1], dtype=np.int64)  # 5.4e12 max
    np.testing.assert_array_equal(_hilo_total(hi, lo), want)


def test_auto_chunk_keeps_blocks_int32_safe():
    from cmtci.stats.pointstats import _auto_chunk

    for n in (100, 65536, 150_000, 2_000_000):
        c = _auto_chunk(n, 1024)
        assert 8 <= c <= 1024 and (c == 1024 or c * n <= 2**31 - 1), (n, c)


def test_sharded_cloud_potential_matches_single_device(rng):
    """Row-sharded K8 grid == the single-device kernel bitwise at equal
    dtype/chunk on the same synthesized coordinates, across mesh sizes and
    both sign conventions."""
    from cmtci.kernels.potential import cloud_log_potential

    pts = rng.uniform(-1.5, 1.0, size=(501, 2))  # non-chunk-multiple cloud
    domain = (-2.25, 1.25, -1.75, 1.75)
    nx, ny = 48, 48
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (nx - 1)
    dy = (ymax - ymin) / (ny - 1)
    for dt in (jnp.float32, jnp.float64):
        cols = jnp.arange(nx, dtype=dt)
        rows = jnp.arange(ny, dtype=dt)
        gx = np.asarray(jnp.broadcast_to((xmin + cols[None, :] * dx).astype(dt), (ny, nx)))
        gy = np.asarray(jnp.broadcast_to((ymin + rows[:, None] * dy).astype(dt), (ny, nx)))
        ref = np.asarray(cloud_log_potential(gx, gy, pts, sign=1, chunk=128))
        for n_dev in (2, 4, 8):
            m = sharded.device_mesh(n_dev)
            got = np.asarray(sharded.sharded_cloud_potential(
                domain, nx, ny, pts, m, sign=1, dtype=dt, chunk=128))
            np.testing.assert_array_equal(got, ref)
    # sign=-1 convention (Laplacian_C-M.py:16-24) and empty-cloud edge
    mesh = sharded.device_mesh()
    ref_neg = np.asarray(cloud_log_potential(gx, gy, pts, sign=-1, chunk=128))
    got_neg = np.asarray(sharded.sharded_cloud_potential(
        domain, nx, ny, pts, mesh, sign=-1, dtype=jnp.float64, chunk=128))
    np.testing.assert_array_equal(got_neg, ref_neg)
    assert not np.asarray(sharded.sharded_cloud_potential(
        domain, nx, ny, np.zeros((0, 2)), mesh)).any()


def test_sharded_cloud_potential_guards():
    import pytest

    mesh = sharded.device_mesh()
    with pytest.raises(ValueError, match="multiple of mesh size"):
        sharded.sharded_cloud_potential((-1, 1, -1, 1), 16, 13,
                                        np.zeros((4, 2)), mesh)
