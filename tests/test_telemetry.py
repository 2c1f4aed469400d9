"""Per-stage device->host transfer telemetry (NOTES r3 item 4).

Per-stage transfer volume is a perf metric: the round-3 tracker win was cutting
the per-stage fetch from the grid-sized bool mask to n_samples int32
indices (VERDICT r2 item 5). These tests lock that property in
mechanically via StageTimer.bytes / artifacts.fetch_bytes_total().
"""

import numpy as np

from cmtci.utils import artifacts

TCI_DOM = (-2.2, 1.2, -1.6, 1.6)


def test_fetch_tallies_device_arrays_only():
    import jax.numpy as jnp

    b0 = artifacts.fetch_bytes_total()
    out = artifacts.fetch(np.zeros(100, dtype=np.float64))
    assert isinstance(out, np.ndarray)
    assert artifacts.fetch_bytes_total() == b0  # host numpy untallied
    out = artifacts.fetch(jnp.zeros(100, dtype=jnp.float32))
    assert artifacts.fetch_bytes_total() == b0 + 400


def test_stage_timer_accrues_bytes_per_stage():
    import jax.numpy as jnp

    t = artifacts.StageTimer()
    with t.stage("a"):
        artifacts.fetch(jnp.zeros(10, dtype=jnp.float32))
    with t.stage("b"):
        artifacts.fetch(jnp.zeros(20, dtype=jnp.float32))
    with t.stage("a"):  # re-entry accrues
        artifacts.fetch(jnp.zeros(5, dtype=jnp.float32))
    assert t.bytes == {"a": 60, "b": 80}
    assert set(t.times) == {"a", "b"}


def test_pallas_sampler_transfer_is_o_n_samples():
    """The device-side Gumbel top-k fetch moves n_samples int32 indices —
    NOT the grid-sized mask. A regression to grid-sized transfer (128^2
    bool = 16 KiB here, f64 fields 4x that) trips the bound."""
    from cmtci.kernels.mandelbrot_pallas import tci_boundary_sample

    n_samples = 200
    b0 = artifacts.fetch_bytes_total()
    pts = tci_boundary_sample(TCI_DOM, 128, n_samples, seed=3, max_iter=60)
    moved = artifacts.fetch_bytes_total() - b0
    assert pts.shape == (n_samples,)
    # n_samples int32 indices + the packed [n_band, n_escaped] header, all
    # in one roundtrip (r4: three fetches -> one)
    assert moved <= (n_samples + 2) * 4
    assert moved < 128 * 128  # far below even a grid-sized bool mask


def test_jax_sampler_transfer_is_grid_sized():
    """Contrast: the f64 XLA path fetches esc/d/cr/ci at grid size (the
    analysis path's documented behavior — it feeds the host quantile)."""
    from cmtci.kernels import mandelbrot as mb

    rng = np.random.RandomState(0)
    b0 = artifacts.fetch_bytes_total()
    mb.sample_boundary_quantile(TCI_DOM, 96, 50, max_iter=60, rng=rng,
                                impl="jax")
    moved = artifacts.fetch_bytes_total() - b0
    assert moved >= 96 * 96 * (1 + 8 + 8 + 8)  # esc + d + cr + ci


def test_tracker_meta_reports_stage_bytes():
    from cmtci.pipelines.tracker import TrackerConfig, run_tracker

    cfg = TrackerConfig(sigma_bins=3.0, t_fixed=3, bins_start=16, bins_max=16,
                        mandelbrot_grid_start=96, construct_max_start=60,
                        mandelbrot_samples_start=500)
    _, meta = run_tracker(cfg)
    assert "stage_bytes" in meta
    sample_keys = [k for k in meta["stage_bytes"] if k.endswith("_sample")]
    assert sample_keys and all(meta["stage_bytes"][k] > 0 for k in sample_keys)


def test_accel_bytes_zero_on_cpu_backend():
    """accel_bytes counts only non-CPU fetches: on the CPU test backend it
    stays zero while bytes accrues — so on a GPU session the two split
    device->host traffic from host-array fetches."""
    import jax.numpy as jnp

    t = artifacts.StageTimer()
    a0 = artifacts.accel_bytes_total()
    with t.stage("s"):
        artifacts.fetch(jnp.zeros(10, dtype=jnp.float32))
    assert t.bytes["s"] == 40
    assert t.accel_bytes["s"] == 0
    assert artifacts.accel_bytes_total() == a0
