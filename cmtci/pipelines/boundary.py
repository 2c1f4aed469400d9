"""Mandelbrot boundary pipeline (BASELINE config 1, call stack SURVEY §3.1).

Reference: mandelbrot_boundary_sample.py — dwell grid (res², max_iter),
isocontour at level_frac*max_iter, longest path, CSV + meta outputs.

The dwell grid runs on the f32 Pallas head in a GPU session (block-padded,
then cropped), else the f64 XLA kernel; a mesh runs the f64 XLA kernel
row-sharded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci.geometry import contour
from cmtci.io import writers
from cmtci.kernels import mandelbrot as mb


@dataclass
class BoundaryConfig:
    xlim: tuple = (-2.1, 0.9)
    ylim: tuple = (-1.5, 1.5)
    res: int = 2000
    max_iter: int = 500
    level: float = 0.96
    backend: str = "auto"  # "pallas" | "xla" | "auto"


def compute_dwell(cfg: BoundaryConfig, mesh=None) -> np.ndarray:
    domain = (*cfg.xlim, *cfg.ylim)
    if mesh is not None:
        from cmtci.parallel.sharded import sharded_dwell_rows

        # row-shard the f64 dwell loop over the mesh on the SAME linspace
        # grid nodes as the single-device path (sharded_dwell_rows —
        # bitwise-identical dwell field). Pad rows to a mesh multiple with
        # copies of the first row, then crop.
        cr, ci = mb.complex_grid(domain, cfg.res, cfg.res)
        cr, ci = np.asarray(cr), np.asarray(ci)
        n_dev = mesh.devices.size
        ny = ((cfg.res + n_dev - 1) // n_dev) * n_dev
        pad = ny - cfg.res
        if pad:
            cr = np.vstack([cr, np.repeat(cr[:1], pad, axis=0)])
            ci = np.vstack([ci, np.repeat(ci[:1], pad, axis=0)])
        z = sharded_dwell_rows(cr, ci, cfg.max_iter, mesh)
        return np.asarray(z)[: cfg.res].astype(float)
    from cmtci.utils.device import on_gpu

    if cfg.backend == "pallas" or (cfg.backend == "auto" and on_gpu()):
        from cmtci.kernels.mandelbrot_pallas import mandelbrot_field_pallas

        z = mandelbrot_field_pallas(domain, cfg.res, cfg.res,
                                    max_iter=cfg.max_iter, kind="dwell")
        return np.asarray(z)

    cr, ci = mb.complex_grid(domain, cfg.res, cfg.res)
    return np.asarray(mb.dwell_grid(cr, ci, max_iter=cfg.max_iter)).astype(float)


def run_boundary(cfg: BoundaryConfig, output_prefix: str | None = None,
                 mesh=None):
    """Returns (contour_vertices, dwell_grid); optionally writes the file bus."""
    xs = np.linspace(cfg.xlim[0], cfg.xlim[1], cfg.res)
    ys = np.linspace(cfg.ylim[0], cfg.ylim[1], cfg.res)
    z = compute_dwell(cfg, mesh=mesh)
    path = contour.extract_contour(xs, ys, z, cfg.level * cfg.max_iter)
    if path is None or path.shape[0] < 50:
        raise RuntimeError("Failed to extract a usable contour; adjust level/res.")
    if output_prefix:
        writers.write_xy_csv(f"{output_prefix}_boundary.csv", path)
        from cmtci.io import plots

        plots.plot_boundary_overlay(path, path, f"{output_prefix}_boundary.png")
        writers.write_meta_txt(f"{output_prefix}_meta.txt", {
            "xlim": list(cfg.xlim), "ylim": list(cfg.ylim), "res": cfg.res,
            "max_iter": cfg.max_iter, "level": cfg.level,
        })
    return path, z
