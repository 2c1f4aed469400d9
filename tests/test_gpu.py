"""The Pallas heads compiled for the GPU, at real widths, against the plain
f64 XLA kernels. Marked `gpu`: they skip off the card and run there with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(chip_smoke.py runs them first). Tolerances are those of
test_pallas_kernel.py; the widths are the reference configs'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmtci.kernels import mandelbrot as mb
from cmtci.kernels import mandelbrot_pallas as mp

pytestmark = pytest.mark.gpu

DOM = (-2.1, 0.9, -1.5, 1.5)   # BASELINE config #1
TCI_DOM = (-2.2, 1.2, -1.6, 1.6)


def test_heads_compile_through_triton(gpu):
    """A GPU session compiles the heads (no interpreter): the lowered
    program holds a Triton kernel call, not an interpreted loop."""
    from cmtci.utils.device import pallas_interpret

    assert pallas_interpret() is False
    with jax.enable_x64(False):
        params = mp._grid_params(DOM, 64, 64)
        text = mp._field.lower(params, 64, 64, 50, "dwell", 4.0, mp.DEFAULT_TILE,
                               mp.DEFAULT_INNER, False).as_text()
    assert "triton" in text


def test_dwell_head_res2000(gpu):
    d32 = np.asarray(mp.mandelbrot_field_pallas(DOM, 2000, 2000, max_iter=500))
    cr, ci = mb.complex_grid(DOM, 2000, 2000)
    ref = np.asarray(mb.dwell_grid(cr, ci, max_iter=500))
    exact = (d32 == ref).mean()
    print(f"dwell res 2000 max_iter 500: {exact:.6f} of pixels exact")
    assert exact >= 0.99


def test_green_and_de_heads_res2000(gpu):
    cr, ci = mb.complex_grid(DOM, 2000, 2000)
    g32 = np.asarray(mp.mandelbrot_field_pallas(DOM, 2000, 2000, max_iter=500,
                                                kind="green", escape_r=4.0))
    g64 = np.asarray(mb.escape_potential_grid(cr, ci, max_iter=500, escape_r=4.0,
                                              normalization="two_pow_n"))
    d32 = np.asarray(mp.mandelbrot_field_pallas(DOM, 2000, 2000, max_iter=500,
                                                kind="de", escape_r=4.0))
    d64 = np.asarray(mb.de_field_std(cr, ci, max_iter=500, escape_r=4.0)[1])
    green = np.isclose(g32, g64, rtol=1e-4, atol=1e-7).mean()
    de = np.isclose(d32, d64, rtol=1e-3, atol=1e-9).mean()
    print(f"green rtol 1e-4: {green:.6f}; de rtol 1e-3: {de:.6f}")
    assert green >= 0.99 and de >= 0.98


def test_tci_head_stage4_grid(gpu):
    """grid 912, max_iter 250 (the tracker's stage-4 DE grid).

    The escape classification is compared with the f64 kernel. The band
    (escaped & d <= q25) is compared with the plain XLA kernel in f32: in
    the TCI semantics dz overflows to inf for all but the latest escapers
    (d = 0), and f32 overflows at 3.4e38 where f64 does at 1.8e308, so at
    250 iterations the f32 d == 0 set — and with it the band — is a
    different set from f64's by construction; the f32 kernel must pick the
    same one the f32 XLA loop does."""
    esc32, d32 = (np.asarray(a) for a in mp.tci_de_field_pallas(TCI_DOM, 912))
    cr, ci = mb.complex_grid(TCI_DOM, 912, 912)
    esc64, d64, _, _ = mb.de_field_tci(cr, ci, max_iter=250)
    esc64, d64 = np.asarray(esc64), np.asarray(d64)
    with jax.enable_x64(False):
        cr32, ci32 = mb.complex_grid(TCI_DOM, 912, 912, dtype=jnp.float32)
        escx, dx, _, _ = mb.de_field_tci(cr32, ci32, max_iter=250)
    escx, dx = np.asarray(escx), np.asarray(dx)

    def band(e, d):
        return e & (d <= np.quantile(d[e], 0.25))

    def jaccard(a, b):
        return (a & b).sum() / (a | b).sum()

    same_esc = (esc32 == esc64).mean()
    jac32 = jaccard(band(esc32, d32), band(escx, dx))
    jac64 = jaccard(band(esc32, d32), band(esc64, d64))
    print(f"tci 912/250: escape classification {same_esc:.6f} equal to f64; "
          f"band Jaccard {jac32:.6f} vs f32 XLA, {jac64:.6f} vs f64; "
          f"d==0 share of escaped: kernel {(d32[esc32] == 0).mean():.4f}, "
          f"f32 XLA {(dx[escx] == 0).mean():.4f}, f64 {(d64[esc64] == 0).mean():.4f}")
    assert same_esc >= 0.995
    assert jac32 > 0.97


def test_cloud_green_equipotential_cloud(gpu):
    """The equipotential pipeline's 20k-point cloud (n = 2..200),
    max_iter 20000."""
    from cmtci.kernels import companion

    cloud = companion.inverse_cloud(list(range(2, 201)))
    g64, k64, _ = mb.green_potential_compacted(cloud, max_iter=20000, escape_r=2.0)
    g32, k32, _ = mp.green_cloud_f32(cloud, max_iter=20000, escape_r=2.0)
    with jax.enable_x64(False):
        _, kx, _ = mb.green_potential_compacted(cloud, max_iter=20000, escape_r=2.0)
    esc = k64 < 20000
    same_k = k32 == k64
    m = esc & same_k
    rel = np.median(np.abs(g32[m] - g64[m]) / np.maximum(g64[m], 1e-300))
    print(f"cloud {cloud.size} points: escaped {esc.sum()}, k differs from f64 "
          f"on {(~same_k).sum()} points (f32 XLA: {(kx != k64).sum()}; kernel vs "
          f"f32 XLA: {(k32 != kx).sum()}), g median rel err {rel:.3e}")
    # identical escape set; k is an f32 orbit realization: a few deep
    # chaotic escapers leave a step earlier or later than in f64
    np.testing.assert_array_equal(esc, k32 < 20000)
    assert same_k[esc].mean() >= 0.995
    assert rel <= 1e-6
