"""The real tracker stage, sharded over the 8-device virtual CPU mesh.

VERDICT round-1 item 2: the multi-chip path must execute the genuine
sample -> match -> Procrustes -> mollify -> GI-flow stage
(gi_assumption_tracker_v3.py:212-247) and equal the single-device
run_tracker stage bitwise (f64).
"""

import numpy as np

import jax
import jax.numpy as jnp

from cmtci.kernels import mandelbrot as mb
from cmtci.parallel import sharded
from cmtci.transport import histogram as hg
from cmtci.transport.sinkhorn import (
    _argmax_kernel_rows, _blocked_mean_dist, entropic_argmax_match,
)

DOMAIN = (-2.2, 1.2, -1.6, 1.6)


def test_sharded_matcher_bitwise(rng):
    mesh = sharded.device_mesh()
    a = rng.normal(size=(700, 2))
    b = rng.normal(size=(500, 2))
    mean = _blocked_mean_dist(jnp.asarray(a), jnp.asarray(b))
    ref = np.asarray(_argmax_kernel_rows(jnp.asarray(a), jnp.asarray(b), mean, 0.8))
    got = sharded.sharded_argmax_match(a, b, 0.8, mesh, chunk=64)
    np.testing.assert_array_equal(got, ref[: len(a)])


def test_sharded_matcher_via_entry_point(rng):
    mesh = sharded.device_mesh()
    x = rng.normal(size=300) + 1j * rng.normal(size=300)
    y = rng.normal(size=300) + 1j * rng.normal(size=300)
    m1, c1 = entropic_argmax_match(x, y, eps=0.8, rng=np.random.RandomState(3))
    m2, c2 = entropic_argmax_match(x, y, eps=0.8, rng=np.random.RandomState(3), mesh=mesh)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(c1, c2)


def test_sharded_de_field_bitwise():
    mesh = sharded.device_mesh()
    esc_s, d_s = sharded.sharded_de_tci_field(DOMAIN, 100, mesh, max_iter=60)
    cr, ci = mb.complex_grid(DOMAIN, 100, 100)
    esc, d, _, _ = mb.de_field_tci(cr, ci, max_iter=60)
    np.testing.assert_array_equal(esc_s, np.asarray(esc))
    np.testing.assert_array_equal(d_s, np.asarray(d))


def test_mollified_histogram_mesh_bitwise(rng):
    mesh = sharded.device_mesh()
    cloud = rng.uniform(-2, 1, 1000) + 1j * rng.uniform(-1.5, 1.5, 1000)
    ref = np.asarray(hg.mollified_histogram(cloud, 32, DOMAIN, 3.0))
    got = np.asarray(hg.mollified_histogram(cloud, 32, DOMAIN, 3.0, mesh=mesh))
    np.testing.assert_array_equal(got, ref)


def test_tracker_stage_mesh_bitwise():
    """Full tracker stage with mesh == single-device stage, bitwise (f64)."""
    import dataclasses

    from cmtci.pipelines.tracker import TrackerConfig, run_tracker

    mesh = sharded.device_mesh()
    cfg = TrackerConfig(bins_start=16, bins_max=16, construct_max_start=60,
                        mandelbrot_grid_start=120, mandelbrot_samples_start=400,
                        max_iter=60, sigma_bins=2.0, t_fixed=5)
    rows_1, _ = run_tracker(cfg, max_stages=1)
    rows_m, _ = run_tracker(cfg, max_stages=1, mesh=mesh)
    r1 = dataclasses.asdict(rows_1[0])
    rm = dataclasses.asdict(rows_m[0])
    for k, v in r1.items():
        if k == "runtime_sec":
            continue
        assert rm[k] == v, (k, rm[k], v)


def test_tracker_train_step_jit():
    """The fixed-shape jitted multi-chip step runs and GI-flow contracts."""
    mesh = sharded.device_mesh()
    ns = list(range(4, 68, 4))
    step = jax.jit(lambda key, t: sharded.tracker_train_step(
        mesh, ns, DOMAIN, grid_n=64, n_samples=64, bins=16, key=key,
        max_iter=32, sigma_bins=1.0, alpha=0.1, t_steps=t, chunk=8,
    ), static_argnums=1)
    out5 = step(jax.random.key(0), 5)
    out20 = step(jax.random.key(0), 20)
    kl0 = float(out5["kl_initial"])
    d5 = float(out5["delta_n"])
    d20 = float(out20["delta_n"])
    assert kl0 > d5 > d20 >= 0.0
    assert float(out5["kl_initial"]) == float(out20["kl_initial"])
    assert 0.0 <= float(out5["tv_PC_PM"]) <= 1.0


def test_sharded_knn_bitwise(rng):
    from cmtci.stats.embeddings import _knn

    mesh = sharded.device_mesh()
    xy = rng.normal(size=(500, 2))
    d_ref, i_ref = _knn(jnp.asarray(xy), 10, chunk=32)
    d_s, i_s = sharded.sharded_knn(xy, 10, mesh, chunk=32)
    np.testing.assert_array_equal(i_s, np.asarray(i_ref))
    np.testing.assert_array_equal(d_s, np.asarray(d_ref))


def test_sharded_diffusion_map(rng):
    from cmtci.stats.embeddings import diffusion_map

    mesh = sharded.device_mesh()
    pts = rng.normal(size=(300, 2))
    vals, vecs, sigma = diffusion_map(pts, k=10)
    vals_m, vecs_m, sigma_m = diffusion_map(pts, k=10, mesh=mesh)
    assert sigma_m == sigma
    np.testing.assert_allclose(vals_m, vals, rtol=1e-12)


def test_sharded_score_angles_bitwise(rng):
    from cmtci.stats.symmetry import _score_angles, best_reflection_axis

    mesh = sharded.device_mesh()
    pts = rng.normal(size=(200, 2))
    angles = np.linspace(0, np.pi, 37)
    ref = _score_angles(pts, angles, 0.05)
    got = sharded.sharded_score_angles(pts, angles, 0.05, mesh)
    np.testing.assert_array_equal(got, ref)
    # entry point agrees too
    b1 = best_reflection_axis(pts, pts * 0.99, n_angles=37, refine=False)
    b2 = best_reflection_axis(pts, pts * 0.99, n_angles=37, refine=False, mesh=mesh)
    assert b1["angle"] == b2["angle"]
    np.testing.assert_array_equal(b1["scan_score"], b2["scan_score"])


def test_sharded_green_cloud_exact():
    from cmtci.kernels import mandelbrot as mbk

    mesh = sharded.device_mesh()
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 1, 400) + 1j * rng.uniform(-1.5, 1.5, 400)
    g1, k1, p1 = mbk.green_potential_compacted(pts, max_iter=600, stage_iters=128)
    g2, k2, p2 = sharded.sharded_green_cloud(pts, max_iter=600, mesh=mesh,
                                             stage_iters=128)
    np.testing.assert_array_equal(g2, g1)
    np.testing.assert_array_equal(k2, k1)
    np.testing.assert_array_equal(p2, p1)


def test_tracker_two_stage_mesh_bitwise():
    """Two growing stages under the mesh: the shared RNG stream must stay
    bitwise-continuous across stages exactly as single-device."""
    import dataclasses

    from cmtci.pipelines.tracker import TrackerConfig, run_tracker

    mesh = sharded.device_mesh()
    cfg = TrackerConfig(bins_start=16, bins_max=32, construct_max_start=60,
                        mandelbrot_grid_start=100, mandelbrot_samples_start=300,
                        max_iter=60, sigma_bins=2.0, t_fixed=5,
                        construct_max_growth=1.3, mandelbrot_grid_growth=1.1,
                        mandelbrot_samples_growth=1.2)
    rows_1, _ = run_tracker(cfg)
    rows_m, _ = run_tracker(cfg, mesh=mesh)
    assert len(rows_1) == len(rows_m) == 2
    for r1, rm in zip(rows_1, rows_m):
        d1 = dataclasses.asdict(r1)
        dm = dataclasses.asdict(rm)
        for k, v in d1.items():
            if k != "runtime_sec":
                assert dm[k] == v, (k, dm[k], v)


def _subjaxprs(p):
    if isinstance(p, (list, tuple)):
        for x in p:
            yield from _subjaxprs(x)
    elif hasattr(p, "jaxpr"):  # ClosedJaxpr
        yield p.jaxpr
    elif hasattr(p, "eqns"):  # Jaxpr
        yield p


def _jaxpr_float64_eqns(jaxpr):
    """All primitive eqns in (sub)jaxprs with any f64 input or output."""
    hits = []

    def walk(jx):
        for eqn in jx.eqns:
            avals = [getattr(v, "aval", None)
                     for v in list(eqn.invars) + list(eqn.outvars)]
            # weak-typed f64 scalars are Python-float literals on their way
            # into an f32 op — not materialized f64 device math
            if any(getattr(a, "dtype", None) == jnp.float64
                   and not getattr(a, "weak_type", False) for a in avals):
                hits.append(eqn.primitive.name)
            for p in eqn.params.values():
                for sub in _subjaxprs(p):
                    walk(sub)

    walk(jaxpr.jaxpr)
    return hits


def test_tracker_train_step_f32_only_device_code():
    """VERDICT r2 item 3: with a host cloud, the traced step is f32-only.

    Traces the full step over the mesh and scans every (sub)jaxpr for f64
    values — the guard against shipping an f64 eigensweep/escape loop to an
    accelerator mesh hidden inside the 'f32' step
    (parallel/sharded.py tracker_train_step accelerator contract).
    """
    mesh = sharded.device_mesh()
    ns = list(range(4, 68, 4))
    cloud = sharded.host_tracker_cloud(ns)
    assert cloud[0].dtype == jnp.float32

    closed = jax.make_jaxpr(lambda key: sharded.tracker_train_step(
        mesh, ns, DOMAIN, grid_n=64, n_samples=64, bins=16, key=key,
        max_iter=32, sigma_bins=1.0, alpha=0.1, t_steps=5, chunk=8,
        cloud=cloud,
    ))(jax.random.key(0))
    f64_eqns = _jaxpr_float64_eqns(closed)
    assert not f64_eqns, f"f64 device ops in the f32 step: {sorted(set(f64_eqns))}"


def test_tracker_train_step_cloud_matches_insweep():
    """cloud= path produces the same diagnostics as the in-step eigensweep
    (same roots, same RNG stream, f32 cast at the same point)."""
    mesh = sharded.device_mesh()
    ns = list(range(4, 68, 4))
    kwargs = dict(grid_n=64, n_samples=64, bins=16, max_iter=32,
                  sigma_bins=1.0, alpha=0.1, t_steps=5, chunk=8)
    key = jax.random.key(0)
    out_in = sharded.tracker_train_step(mesh, ns, DOMAIN, key=key, **kwargs)
    out_cl = sharded.tracker_train_step(mesh, ns, DOMAIN, key=key,
                                        cloud=sharded.host_tracker_cloud(ns),
                                        **kwargs)
    for k in out_in:
        np.testing.assert_allclose(np.asarray(out_cl[k]), np.asarray(out_in[k]),
                                   rtol=1e-6, err_msg=k)


def test_masked_quantile_empty_mask_is_inf_sentinel():
    """ADVICE r2 low: all-false mask yields the +inf sentinel, not NaN."""
    vals = jnp.asarray([3.0, 1.0, 2.0], dtype=jnp.float32)
    q = sharded._masked_quantile(vals, jnp.zeros(3, bool), 0.25)
    assert np.isinf(float(q)) and float(q) > 0
    # and the normal path still matches numpy
    m = jnp.asarray([True, False, True])
    want = np.quantile(np.asarray([3.0, 2.0]), 0.25)
    np.testing.assert_allclose(float(sharded._masked_quantile(vals, m, 0.25)), want)
