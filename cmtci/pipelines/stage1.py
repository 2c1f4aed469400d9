"""Stage-1 cleaning pipeline (P6): builds the canonical file bus.

Reference: construct_stage1_clean.py:147-195 — cloud (n=2..maxN), DE
band-threshold boundary sample with d-weighted subsampling, PCA orientation
features, Sinkhorn-or-greedy matching on [features|coords], Procrustes, and
the four file-bus CSVs (construct_points / mandel_boundary_sample /
construct_aligned / matches_indices).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci.io import writers
from cmtci.kernels import companion, mandelbrot as mb
from cmtci.transport.procrustes import procrustes_align_no_scale
from cmtci.transport.sinkhorn import sinkhorn_log


@dataclass
class Stage1Config:
    max_n: int = 40
    nx: int = 120
    ny: int = 80
    max_iter: int = 200
    bailout: float = 1e6
    threshold_low: float = 1e-6
    threshold_high: float = 1e-1
    boundary_samples: int = 600
    k_orientation: int = 8
    matcher: str = "sinkhorn"  # "sinkhorn" | "greedy"
    sinkhorn_reg: float = 1e-2
    seed: int = 0
    cloud_backend: str = "aberth"


def sample_boundary_band(cfg: Stage1Config, rng) -> np.ndarray:
    """DE band-threshold sampler with d-weighted choice (stage1:60-80)."""
    xs = np.linspace(-2.25, 1.25, cfg.nx)
    ys = np.linspace(-1.25, 1.25, cfg.ny)
    cr, ci = np.meshgrid(xs, ys, indexing="xy")

    esc, d = mb.de_field_stage1(cr, ci, max_iter=cfg.max_iter, bailout=cfg.bailout)
    d = np.asarray(d)
    keep = (d > cfg.threshold_low) & (d < cfg.threshold_high)
    cand = np.column_stack([cr[keep], ci[keep]])
    vals = d[keep]
    if len(cand) == 0:
        return np.empty((0, 2))
    if len(cand) <= cfg.boundary_samples:
        return cand
    probs = vals / vals.sum()
    idx = rng.choice(len(cand), size=cfg.boundary_samples, replace=False, p=probs)
    return cand[idx]


def orientation_features(x: np.ndarray, k: int = 8) -> np.ndarray:
    """Dominant local PCA direction per point (stage1:82-107), vectorized."""
    n = len(x)
    if n == 0:
        return np.zeros((0, 2))
    k = min(k, n)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    idxs = np.argsort(d2, axis=1)[:, 1 : k + 1] if k < n else np.argsort(d2, axis=1)[:, :k]
    neigh = x[idxs]  # (N,k,2)
    m = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", m, m)
    vals, vecs = np.linalg.eigh(cov)
    return vecs[:, :, -1]  # dominant eigenvector per point


def greedy_match(xa: np.ndarray, xb: np.ndarray) -> np.ndarray:
    """Nearest-neighbor matching in feature space (stage1:121-133)."""
    d2 = ((xa[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1)


def run_stage1(cfg: Stage1Config, outdir: str | None = None):
    """Returns dict(C, M, C_aligned, matches); writes the file bus if outdir."""
    rng = np.random.RandomState(cfg.seed)
    ns = list(range(2, cfg.max_n + 1))
    cz = companion.inverse_cloud(ns, "lucas_all_ones", tol=1e-12, backend=cfg.cloud_backend)
    c = np.column_stack([cz.real, cz.imag])
    m = sample_boundary_band(cfg, rng)

    f_c = orientation_features(c, cfg.k_orientation)
    f_m = orientation_features(m, cfg.k_orientation)
    xa = np.hstack([f_c, c])
    xb = np.hstack([f_m, m])

    if len(m) == 0:
        raise ValueError(
            "stage1: no boundary points in the DE band — adjust "
            "threshold_low/threshold_high/bailout (both matchers need a "
            "non-empty Mandelbrot sample)")
    if cfg.matcher == "sinkhorn":

        d = np.sqrt(((xa[:, None, :] - xb[None, :, :]) ** 2).sum(-1))
        # raw euclidean cost + reg, POT-default 1000 iterations, like the
        # reference's ot.sinkhorn call (construct_stage1_clean.py:110-116)
        plan = np.asarray(sinkhorn_log(d, iters=1000, eps=cfg.sinkhorn_reg))
        matches = plan.argmax(axis=1)
    else:
        matches = greedy_match(xa, xb)

    cz_aligned = procrustes_align_no_scale(
        cz, m[matches][:, 0] + 1j * m[matches][:, 1], convention="fixed"
    )
    c_aligned = np.column_stack([cz_aligned.real, cz_aligned.imag])

    if outdir:
        writers.write_points_csv(f"{outdir}/construct_points.csv", c)
        writers.write_points_csv(f"{outdir}/mandel_boundary_sample.csv", m)
        writers.write_points_csv(f"{outdir}/construct_aligned.csv", c_aligned)
        writers.write_matches_csv(f"{outdir}/matches_indices.csv", matches)
        writers.write_config_meta(f"{outdir}/meta.txt", cfg)
        from cmtci.io import plots

        plots.plot_alignment(c, m, c_aligned, f"{outdir}/alignment.png")
    return {"C": c, "M": m, "C_aligned": c_aligned, "matches": matches}
