"""Multi-chip execution: sharded grids, eigensweeps, and reductions.

The reference is single-process with no parallelism (SURVEY.md §2/§5.8: the
one multiprocessing import is dead code). The scaling story here is
data parallelism over a `jax.sharding.Mesh`:

  * escape-time / potential grids sharded by rows (embarrassingly parallel,
    coordinates synthesized per shard from the axis index),
  * batched companion eigensolves sharded over the polynomial batch,
  * histogram / moment accumulation via per-shard partials + `psum` across devices,
  * GI-flow iterations on the replicated histograms.

Everything uses shard_map so each device runs an independent escape loop /
Aberth iteration (no collectives inside the hot loops; one psum at the
reduction edge). `tracker_train_step` is the REAL tracker stage
(sample -> match -> Procrustes -> mollify -> GI-flow) as one jittable
multi-chip step, used by the driver's dry run; `sharded_argmax_match` /
`sharded_de_tci_field` / the mesh path of transport.histogram are
bitwise-identical to their single-device counterparts and are what
run_tracker(mesh=...) uses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from cmtci.kernels import companion
from cmtci.kernels import mandelbrot as mb
from cmtci.utils import cplx


def device_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first n devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("data",))


def _dwell_local(cr, ci, max_iter: int):
    """Elementwise f32 dwell loop (runs per shard, no communication)."""
    zr = jnp.zeros_like(cr)
    zi = jnp.zeros_like(ci)
    act = jnp.ones_like(cr)
    dwell = jnp.zeros_like(cr)

    def body(_, s):
        zr, zi, act, dwell = s
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        inside = zr * zr + zi * zi <= 4.0
        act = act * jnp.where(inside, 1.0, 0.0)
        zr = jnp.where(inside, zr, 0.0)
        zi = jnp.where(inside, zi, 0.0)
        return zr, zi, act, dwell + act

    _, _, _, dwell = jax.lax.fori_loop(0, max_iter, body, (zr, zi, act, dwell))
    return dwell


def sharded_dwell_grid(domain, nx: int, ny: int, max_iter: int, mesh: Mesh,
                       dtype=jnp.float32):
    """Row-sharded dwell grid over the mesh. ny must divide by mesh size."""
    n_dev = mesh.devices.size
    if ny % n_dev:
        raise ValueError(f"ny={ny} must be a multiple of mesh size {n_dev}")
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (nx - 1)
    dy = (ymax - ymin) / (ny - 1)
    rows_per = ny // n_dev

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(), out_specs=P("data", None),
        check_vma=False,
    )
    def run():
        idx = jax.lax.axis_index("data")
        row0 = (idx * rows_per).astype(dtype)
        rows = row0 + jnp.arange(rows_per, dtype=dtype)
        cols = jnp.arange(nx, dtype=dtype)
        cr = jnp.broadcast_to((xmin + cols[None, :] * dx).astype(dtype), (rows_per, nx))
        ci = (ymin + rows[:, None] * dy).astype(dtype)
        ci = jnp.broadcast_to(ci, (rows_per, nx))
        return _dwell_local(cr, ci, max_iter)

    return run()


def sharded_dwell_rows(cr, ci, max_iter: int, mesh: Mesh):
    """Row-sharded dwell loop over PRECOMPUTED coordinate grids.

    Unlike sharded_dwell_grid (which synthesizes xmin + i·dx per shard),
    this takes the caller's exact grid nodes — e.g. np.linspace grids, so
    a mesh run of the boundary pipeline produces bitwise the SAME dwell
    field as the single-device f64 path: each shard runs that path's own
    kernel (kernels.mandelbrot.dwell_grid) on the same nodes (linspace and
    affine synthesis differ at the ulp level, and borderline escape pixels
    flip on ulps, as do two loop formulations that XLA contracts into FMAs
    differently). ny must be a mesh multiple (pad + crop at the call site).
    """
    cr = jnp.asarray(cr)
    n_dev = mesh.devices.size
    if cr.shape[0] % n_dev:
        raise ValueError(f"ny={cr.shape[0]} must be a multiple of mesh "
                         f"size {n_dev}")

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("data", None), P("data", None)),
        out_specs=P("data", None), check_vma=False,
    )
    def run(cr_l, ci_l):
        return mb.dwell_grid(cr_l, ci_l, max_iter=max_iter)

    return run(cr, jnp.asarray(ci))


def sharded_eigensweep(ns, family: str = "lucas_all_ones", mesh: Mesh | None = None,
                       max_iters: int = 200):
    """Companion eigensweep with the polynomial batch sharded over devices.

    Pads the batch to a mesh multiple; returns (re, im, valid) with padding
    rows masked out.
    """
    if mesh is None:
        mesh = device_mesh()
    fam = family if companion._closed_form_ok(ns, family) else None
    a, deg = companion.poly_coeff_batch(ns, family)
    n_dev = mesh.devices.size
    b = a.shape[0]
    b_pad = ((b + n_dev - 1) // n_dev) * n_dev
    a = jnp.pad(a, ((0, b_pad - b), (0, 0)))
    a = a.at[b:, 0].set(1.0)  # pad rows: low-degree polys (zero coefficients)
    # pad-row degree must satisfy the closed form's own eligibility gate:
    # sparser's geometric identity needs n >= 2 (deg=1 hits the k_exp=-1
    # corner _newton_ratio_closed's derivative does not cover, and a
    # non-freezing pad lane would pin every device's while_loop at
    # max_iters). Padding values are sliced away either way.
    pad_deg = 2 if fam == "sparser_gap_1_0_1_then_ones" else 1
    deg = jnp.pad(deg, (0, b_pad - b), constant_values=pad_deg)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("data", None), P("data")),
        out_specs=(P("data", None), P("data", None), P("data", None)),
        check_vma=False,
    )
    def run(a_loc, deg_loc):
        zr, zi, valid = companion.aberth_roots(a_loc, deg_loc, max_iters=max_iters,
                                               family=fam)
        return zr, zi, valid

    zr, zi, valid = run(a, deg)
    return zr[:b], zi[:b], valid[:b]


def sharded_histogram(points_r, points_i, bins: int, domain, mesh: Mesh):
    """Per-shard 2D histogram + psum; input sharded along the point axis.

    Uses the same np.linspace edges as the host path (transport.histogram),
    so per-bin integer counts psum to the bitwise-identical histogram.
    """
    from cmtci.transport.histogram import histogram2d_edges, np_edges

    xedges, yedges = np_edges(bins, domain)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P(),
        check_vma=False,
    )
    def run(xr, xi):
        # edges in the points' dtype so an f32 step stays f32-only on device
        # (f64 callers get the exact np.linspace f64 edges as before)
        h = histogram2d_edges(xr, xi, bins, jnp.asarray(xedges, dtype=xr.dtype),
                              jnp.asarray(yedges, dtype=xr.dtype),
                              domain[1], domain[3])
        return jax.lax.psum(h, "data")

    return run(points_r, points_i)


def sharded_semivariogram(coords, values, r_edges, mesh: Mesh, chunk: int = 512):
    """All-pairs semivariogram with the i-rows sharded over the mesh.

    Each device bins its row block against the full (replicated) point set
    with a global j > i mask, then per-bin (sum, count) partials are
    psum-reduced — the multi-chip form of stats.variogram.grid_semivariogram
    (exactly equal to it; no pair caps). Returns (gamma, counts).
    """
    coords = np.asarray(coords, dtype=float)
    values = np.asarray(values, dtype=float)
    n = len(coords)
    n_dev = mesh.devices.size
    n_pad = ((n + n_dev * chunk - 1) // (n_dev * chunk)) * (n_dev * chunk)
    cp = np.pad(coords, ((0, n_pad - n), (0, 0)))
    vp = np.pad(values, (0, n_pad - n))
    edges = jnp.asarray(np.asarray(r_edges, dtype=float))
    nbins = len(r_edges) - 1
    rows_per = n_pad // n_dev

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("data", None), P("data"), P(None, None), P(None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(c_loc, v_loc, c_all, v_all):
        dev = jax.lax.axis_index("data")
        row0 = dev * rows_per
        cols = jnp.arange(n_pad)

        def body(i, acc):
            sums, counts = acc
            blk_c = jax.lax.dynamic_slice_in_dim(c_loc, i * chunk, chunk, axis=0)
            blk_v = jax.lax.dynamic_slice_in_dim(v_loc, i * chunk, chunk)
            gidx = row0 + i * chunk + jnp.arange(chunk)
            d = jnp.sqrt(jnp.sum((blk_c[:, None, :] - c_all[None, :, :]) ** 2, axis=-1))
            dv2 = (blk_v[:, None] - v_all[None, :]) ** 2
            valid = (gidx[:, None] < n) & (cols[None, :] > gidx[:, None]) & (cols[None, :] < n)
            b = jnp.searchsorted(edges, d.ravel(), side="right") - 1
            ok = valid.ravel() & (b >= 0) & (b < nbins) & (d.ravel() >= edges[0])
            b = jnp.where(ok, b, nbins)
            sums = sums.at[b].add(jnp.where(ok, dv2.ravel(), 0.0))
            counts = counts.at[b].add(ok.astype(sums.dtype))
            return sums, counts

        init = (jnp.zeros(nbins + 1), jnp.zeros(nbins + 1))
        sums, counts = jax.lax.fori_loop(0, rows_per // chunk, body, init)
        return jax.lax.psum(sums[:-1], "data"), jax.lax.psum(counts[:-1], "data")

    sums, counts = run(jnp.asarray(cp), jnp.asarray(vp), jnp.asarray(cp), jnp.asarray(vp))
    sums, counts = np.asarray(sums), np.asarray(counts)
    gamma = np.zeros(nbins)
    nz = counts > 0
    gamma[nz] = 0.5 * sums[nz] / counts[nz]
    return gamma, counts


def sharded_binned_sq_diff(c1, v1, c2, v2, r_edges, mesh: Mesh,
                           upper: bool = True, chunk: int = 512, dtype=None):
    """stats.variogram._binned_sq_diff with the i-rows sharded over the mesh.

    Each device bins its row block's (value-difference)² against the full
    replicated (c2, v2) set with the scatter-free masked-reduction kernel
    (stats.variogram.masked_bin_reduce — bin semantics identical to
    searchsorted(side="right")-1, so counts are EXACTLY the host path's);
    per-device (sums, int32 counts) partials are summed on the host in
    f64/int64. upper=True applies the global j > i self-pair mask (the
    grid-semivariogram form), upper=False bins the full rectangle (the
    cross-semivariogram form). Returns (sums, counts int64).
    Reference: variograms_construct_mandelbrot.py:178-315.
    """
    from cmtci.stats.variogram import masked_bin_reduce

    dt = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    c1 = np.asarray(c1, dtype=float)
    v1 = np.asarray(v1, dtype=float)
    c2 = np.asarray(c2, dtype=float)
    v2 = np.asarray(v2, dtype=float)
    n1, n2 = len(c1), len(c2)
    n_dev = mesh.devices.size
    per = chunk * n_dev
    n_pad = ((n1 + per - 1) // per) * per
    rows_per = n_pad // n_dev
    if rows_per * max(n2, 1) > 2**31 - 1:
        raise ValueError(
            f"sharded_binned_sq_diff: {n1}x{n2} pairs over {n_dev} devices "
            f"can overflow a device's signed int32 per-bin partial "
            f"(rows_per={rows_per}); use more devices or subsample")
    nbins = len(r_edges) - 1
    edges = jnp.asarray(np.asarray(r_edges, dtype=float), dt)
    c1p = jnp.asarray(np.pad(c1, ((0, n_pad - n1), (0, 0))), dt)
    v1p = jnp.asarray(np.pad(v1, (0, n_pad - n1)), dt)
    c2j = jnp.asarray(c2, dt)
    v2j = jnp.asarray(v2, dt)
    cols = jnp.arange(n2)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("data", None), P("data"), P(None, None), P(None)),
        out_specs=(P("data", None), P("data", None)), check_vma=False,
    )
    def run(c_loc, v_loc, c_all, v_all):
        dev = jax.lax.axis_index("data")
        row0 = dev * rows_per

        def body(i, acc):
            s_acc, n_acc = acc
            blk_c = jax.lax.dynamic_slice_in_dim(c_loc, i * chunk, chunk, 0)
            blk_v = jax.lax.dynamic_slice_in_dim(v_loc, i * chunk, chunk)
            gidx = row0 + i * chunk + jnp.arange(chunk)
            d = jnp.sqrt(jnp.sum((blk_c[:, None, :] - c_all[None, :, :]) ** 2,
                                 axis=-1))
            dv2 = (blk_v[:, None] - v_all[None, :]) ** 2
            valid = jnp.broadcast_to(gidx[:, None] < n1, d.shape)
            if upper:
                valid = valid & (cols[None, :] > gidx[:, None])
            s_bin, n_bin = masked_bin_reduce(d, valid, edges, nbins,
                                             dvv=jnp.where(valid, dv2, 0.0))
            return s_acc + s_bin, n_acc + n_bin

        init = (jnp.zeros(nbins, dtype=dt), jnp.zeros(nbins, dtype=jnp.int32))
        s, c = jax.lax.fori_loop(0, rows_per // chunk, body, init)
        return s[None], c[None]

    s_parts, n_parts = run(c1p, v1p, c2j, v2j)
    return (np.asarray(s_parts, np.float64).sum(axis=0),
            np.asarray(n_parts, np.int64).sum(axis=0))


def sharded_point_variogram(locs, values=None, max_dist=None, nbins: int = 50,
                            mesh: Mesh | None = None, chunk: int = 512,
                            dtype=None):
    """stats.variogram.point_variogram with the i-rows sharded over the mesh.

    Bin semantics identical to the host path (np.digitize(d, bins)-1 ==
    masked_bin_reduce's d < edges cumulative form, d == max_dist dropped);
    counts are exact int64 sums of per-device int32 partials. max_dist=None
    derives the host default 0.5·max(d) with a first sharded max pass
    (lax.pmax over the mesh) so no pair distance ever lands on the host.
    Returns (centers, gamma, counts) like the host function.
    Reference: Iterative_Variogram_Laplacian.py:53-87.
    """
    from cmtci.stats.variogram import masked_bin_reduce

    if mesh is None:
        mesh = device_mesh()
    dt = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    locs = np.asarray(locs, dtype=float)
    n = len(locs)
    if n < 2:
        centers = np.linspace(0, max_dist or 1.0, nbins + 1)
        centers = 0.5 * (centers[:-1] + centers[1:])
        return centers, np.full(nbins, np.nan), np.zeros(nbins, dtype=np.int64)
    n_dev = mesh.devices.size
    per = chunk * n_dev
    n_pad = ((n + per - 1) // per) * per
    rows_per = n_pad // n_dev
    if rows_per * (n - 1) > 2**31 - 1:
        raise ValueError(
            f"sharded_point_variogram: {n} points over {n_dev} devices can "
            f"overflow a device's signed int32 per-bin partial")
    use_values = values is not None
    vals = (np.zeros(n) if values is None else np.asarray(values, dtype=float))
    lp = jnp.asarray(np.pad(locs, ((0, n_pad - n), (0, 0))), dt)
    vp = jnp.asarray(np.pad(vals, (0, n_pad - n)), dt)
    l_all = jnp.asarray(locs, dt)
    v_all = jnp.asarray(vals, dt)
    cols = jnp.arange(n)
    md = jnp.asarray(0.0 if max_dist is None else max_dist, dt)
    auto_max = max_dist is None

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("data", None), P("data"), P(None, None), P(None), P()),
        out_specs=(P("data", None), P("data", None), P()), check_vma=False,
    )
    def run(l_loc, v_loc, l_rep, v_rep, md_in):
        dev = jax.lax.axis_index("data")
        row0 = dev * rows_per

        def dists_block(i):
            blk = jax.lax.dynamic_slice_in_dim(l_loc, i * chunk, chunk, 0)
            gidx = row0 + i * chunk + jnp.arange(chunk)
            d = jnp.sqrt(jnp.sum((blk[:, None, :] - l_rep[None, :, :]) ** 2,
                                 axis=-1))
            valid = (gidx[:, None] < cols[None, :]) & (cols[None, :] < n)
            return d, valid, gidx

        if auto_max:
            def body_max(i, acc):
                d, valid, _ = dists_block(i)
                return jnp.maximum(acc, jnp.max(jnp.where(valid, d, -jnp.inf)))

            dmax = jax.lax.fori_loop(0, rows_per // chunk, body_max,
                                     jnp.asarray(-jnp.inf, dt))
            max_d = jnp.asarray(0.5, dt) * jax.lax.pmax(dmax, "data")
        else:
            max_d = md_in
        edges = jnp.linspace(jnp.asarray(0.0, dt), max_d, nbins + 1)

        def body(i, acc):
            s_acc, n_acc = acc
            d, valid, gidx = dists_block(i)
            if use_values:
                blk_v = jax.lax.dynamic_slice_in_dim(v_loc, i * chunk, chunk)
                dv2 = (blk_v[:, None] - v_rep[None, :]) ** 2
            else:
                dv2 = d * d
            s_bin, n_bin = masked_bin_reduce(d, valid, edges, nbins,
                                             dvv=jnp.where(valid, dv2, 0.0))
            return s_acc + s_bin, n_acc + n_bin

        init = (jnp.zeros(nbins, dtype=dt), jnp.zeros(nbins, dtype=jnp.int32))
        s, c = jax.lax.fori_loop(0, rows_per // chunk, body, init)
        return s[None], c[None], max_d

    s_parts, n_parts, max_d = run(lp, vp, l_all, v_all, md)
    sums = np.asarray(s_parts, np.float64).sum(axis=0)
    counts = np.asarray(n_parts, np.int64).sum(axis=0)
    bins = np.linspace(0.0, float(max_d), nbins + 1)
    centers = 0.5 * (bins[:-1] + bins[1:])
    gamma = np.full(nbins, np.nan)
    nz = counts > 0
    gamma[nz] = 0.5 * sums[nz] / counts[nz]
    return centers, gamma, counts


def sharded_shell_counts(points, r_max: float, dr: float, mesh: Mesh,
                         chunk: int = 1024, dtype=None):
    """stats.pointstats._shell_counts with the i-rows sharded over the mesh.

    Each device bins its row block's upper-triangle pair distances against
    the replicated cloud with the same scatter-free masked-reduction kernel
    as the single-device head (stats/variogram.masked_bin_reduce, so bin
    semantics are identical bit for bit at equal dtype), accumulating an
    exact (hi, lo) int32 pair with a per-block carry spill
    (pointstats._hilo_spill) — no pair-count ceiling; the only int32 bound
    is per block (chunk·n), which _auto_chunk sizes away. The host
    reconstructs int64 partials and sums. Returns the `_shells` tuple
    (r_vals, counts_f64, n, rho) that stats.pointstats.pair_correlation /
    ripley_k accept directly. Reference: spatial_stats_phase2.py:9-47.
    """
    from cmtci.stats.variogram import masked_bin_reduce
    from cmtci.utils.arrays import as_xy

    from cmtci.stats.pointstats import _auto_chunk, _hilo_spill, _hilo_total

    xy = as_xy(points)
    n = len(xy)
    n_dev = mesh.devices.size
    chunk = _auto_chunk(n, chunk)  # per-block chunk·n pairs must fit int32
    per = chunk * n_dev
    n_pad = ((n + per - 1) // per) * per
    rows_per = n_pad // n_dev
    area = (xy[:, 0].max() - xy[:, 0].min()) * (xy[:, 1].max() - xy[:, 1].min())
    rho = n / area
    r_vals = np.arange(0, r_max, dr)
    nbins = len(r_vals)
    dt = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    edges = jnp.asarray(np.concatenate([r_vals, [r_vals[-1] + dr]]), dt)
    xp = jnp.asarray(np.pad(xy, ((0, n_pad - n), (0, 0))), dt)
    cols = jnp.arange(n_pad)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("data", None), P(None, None)),
        out_specs=(P("data", None), P("data", None)), check_vma=False,
    )
    def run(x_loc, x_all):
        dev = jax.lax.axis_index("data")
        row0 = dev * rows_per

        def body(i, acc):
            hi, lo = acc
            blk = jax.lax.dynamic_slice_in_dim(x_loc, i * chunk, chunk, axis=0)
            gidx = row0 + i * chunk + jnp.arange(chunk)
            d = jnp.sqrt(jnp.sum((blk[:, None, :] - x_all[None, :, :]) ** 2,
                                 axis=-1))
            valid = (gidx[:, None] < cols[None, :]) & (cols[None, :] < n)
            # exact (hi, lo) int32 accumulation with a per-block carry
            # spill — no 2^31 per-device pair ceiling (pointstats._hilo_*)
            return _hilo_spill(hi, lo + masked_bin_reduce(d, valid, edges,
                                                          nbins))

        acc = (jnp.zeros(nbins, dtype=jnp.int32),
               jnp.zeros(nbins, dtype=jnp.int32))
        hi, lo = jax.lax.fori_loop(0, rows_per // chunk, body, acc)
        return hi[None], lo[None]

    hi, lo = run(xp, xp)
    counts = _hilo_total(hi, lo).sum(axis=0)
    return r_vals, counts.astype(np.float64), n, rho


# ---------------------------------------------------------------------------
# Sharded analysis subsystems: embeddings kNN, symmetry angle scan, Green
# clouds (SURVEY §5.8; VERDICT round-1 item 9)
# ---------------------------------------------------------------------------


def sharded_knn(xy, k: int, mesh: Mesh, chunk: int = 2048):
    """Blocked dense kNN with the query rows sharded over the mesh.

    Bitwise-identical to stats.embeddings._knn (each row's top-k involves
    only that row and the replicated point set; identical block shapes).
    Returns host (distances (n,k), indices (n,k)).
    """
    xy = jnp.asarray(xy)
    n = xy.shape[0]
    n_dev = mesh.devices.size
    per = chunk * n_dev
    npad = ((n + per - 1) // per) * per
    xp = jnp.pad(xy, ((0, npad - n), (0, 0)), constant_values=jnp.inf)
    rows_per = npad // n_dev
    k_loc = rows_per // chunk

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("data", None), P(None, None)),
        out_specs=(P("data", None), P("data", None)), check_vma=False,
    )
    def run(x_loc, x_all):
        dev = jax.lax.axis_index("data")
        row0 = dev * rows_per

        def body(i, acc):
            dists, idxs = acc
            blk = jax.lax.dynamic_slice_in_dim(x_loc, i * chunk, chunk, axis=0)
            ridx = row0 + i * chunk + jnp.arange(chunk)
            d2 = jnp.sum((blk[:, None, :] - x_all[None, :, :]) ** 2, axis=-1)
            d2 = jnp.where(ridx[:, None] == jnp.arange(n)[None, :], jnp.inf, d2)
            negd, nbr = jax.lax.top_k(-d2, k)
            dists = jax.lax.dynamic_update_slice_in_dim(dists, jnp.sqrt(-negd), i * chunk, axis=0)
            idxs = jax.lax.dynamic_update_slice_in_dim(idxs, nbr, i * chunk, axis=0)
            return dists, idxs

        dists = jnp.zeros((rows_per, k), dtype=x_loc.dtype)
        idxs = jnp.zeros((rows_per, k), dtype=jnp.int32)
        return jax.lax.fori_loop(0, k_loc, body, (dists, idxs))

    dists, idxs = run(xp, xy)
    return np.asarray(dists)[:n], np.asarray(idxs)[:n]


def sharded_score_angles(points, angles, tol: float, mesh: Mesh):
    """Symmetry preservation fractions with the ANGLE scan sharded.

    The natural parallel axis of the 361-angle reflection scan
    (symmetry_phase_bestaxis.py:153-199): each device scores its angle
    slice against the replicated cloud. Per-angle results are independent,
    so this equals stats.symmetry._score_angles bitwise.
    """
    from cmtci.stats import symmetry as sym_mod
    from cmtci.utils.arrays import as_xy

    p = jnp.asarray(as_xy(points))
    angles = np.asarray(angles, dtype=float)
    a = len(angles)
    n_dev = mesh.devices.size
    apad = ((a + n_dev - 1) // n_dev) * n_dev
    ang = jnp.pad(jnp.asarray(angles), (0, apad - a))

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("data"), P(None, None)),
        out_specs=P("data"), check_vma=False,
    )
    def run(ang_loc, p_all):
        origin = p_all.mean(axis=0)
        refl = sym_mod._reflect_batch(p_all, ang_loc, origin)

        def frac(q):
            d = sym_mod.nearest_distances(q, p_all)
            return jnp.mean((d <= tol).astype(p_all.dtype))

        return jax.lax.map(frac, refl)

    return np.asarray(run(ang, p))[:a]


def green_stage_executor(mesh: Mesh):
    """Point-sharded executor for kernels.mandelbrot._green_stage.

    Plugs into green_potential_compacted(stage_executor=...): each
    compaction stage's active batch is split over the mesh (elementwise
    orbits, bitwise-identical per point); the host compaction loop is
    unchanged.
    """

    def exec_(zr, zi, cr, ci, k0, iters, r2, dtype_max_iter):
        n = zr.shape[0]
        n_dev = mesh.devices.size
        npad = ((n + n_dev - 1) // n_dev) * n_dev
        pad = npad - n
        args = [jnp.pad(jnp.asarray(x), (0, pad)) for x in (zr, zi, cr, ci)]

        @functools.partial(
            shard_map, mesh=mesh, in_specs=(P("data"),) * 4,
            out_specs=(P("data"),) * 7, check_vma=False,
        )
        def run(zr_l, zi_l, cr_l, ci_l):
            return mb._green_stage(zr_l, zi_l, cr_l, ci_l, k0, iters, r2,
                                   dtype_max_iter)

        out = run(*args)
        return tuple(o[:n] for o in out)

    return exec_


def sharded_green_cloud(points, max_iter: int = 20000, escape_r: float = 2.0,
                        mesh: Mesh | None = None, stage_iters: int = 512):
    """g_M/Phi of a point cloud, point-sharded over the mesh.

    The host-compaction staging of green_potential_compacted with each
    stage's kernel executed across the devices. Exactly equal to the
    single-device path (same per-point arithmetic, same compaction walk).
    """
    if mesh is None:
        mesh = device_mesh()
    return mb.green_potential_compacted(points, max_iter=max_iter,
                                        escape_r=escape_r, stage_iters=stage_iters,
                                        stage_executor=green_stage_executor(mesh))


def sharded_cloud_potential(domain, nx: int, ny: int, pts, mesh: Mesh,
                            eps: float = 1e-12, sign: int = 1,
                            dtype=jnp.float32, chunk: int = 2048):
    """Row-sharded cloud log-potential grid (K8's multi-chip head).

    Each device synthesizes its row block's coordinates from the axis index
    (like sharded_dwell_grid) and accumulates the SAME blocked point-chunk
    reduction as kernels.potential._accumulate over the replicated cloud —
    per-pixel sums are independent, so there are no collectives (SURVEY
    §5.8: all comm is map+reduce; here the reduce is over the replicated
    point axis, done locally). Bitwise-identical to cloud_log_potential on
    the same synthesized coordinates (same chunk walk per pixel).
    Reference conventions: Potentials.py:19-27 (sign=+1),
    Laplacian_C-M.py:16-24 / variograms_construct_mandelbrot.py:128-146
    (sign=-1). ny must be a mesh multiple. Returns the (ny, nx) grid.
    """
    from cmtci.kernels.potential import _accumulate
    from cmtci.utils.arrays import as_xy

    n_dev = mesh.devices.size
    if ny % n_dev:
        raise ValueError(f"ny={ny} must be a multiple of mesh size {n_dev}")
    xy = as_xy(pts)
    n = len(xy)
    if n == 0:
        return jnp.zeros((ny, nx), dtype=dtype)
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (nx - 1)
    dy = (ymax - ymin) / (ny - 1)
    rows_per = ny // n_dev
    n_pad = ((n + chunk - 1) // chunk) * chunk
    px = jnp.asarray(np.pad(xy[:, 0], (0, n_pad - n)), dtype)
    py = jnp.asarray(np.pad(xy[:, 1], (0, n_pad - n)), dtype)
    w = jnp.asarray(np.pad(np.ones(n), (0, n_pad - n)), dtype)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(None),) * 3,
        out_specs=P("data", None), check_vma=False,
    )
    def run(px_r, py_r, w_r):
        idx = jax.lax.axis_index("data")
        row0 = (idx * rows_per).astype(dtype)
        rows = row0 + jnp.arange(rows_per, dtype=dtype)
        cols = jnp.arange(nx, dtype=dtype)
        gx = jnp.broadcast_to((xmin + cols[None, :] * dx).astype(dtype),
                              (rows_per, nx))
        gy = jnp.broadcast_to((ymin + rows[:, None] * dy).astype(dtype),
                              (rows_per, nx))
        return _accumulate(gx, gy, px_r, py_r, w_r, jnp.dtype(dtype).type(eps),
                           1 if sign > 0 else -1, chunk)

    return run(px, py, w) / n


# ---------------------------------------------------------------------------
# The real tracker stage, sharded (gi_assumption_tracker_v3.py:212-247)
# ---------------------------------------------------------------------------


def _match_core(rows, b_all, mean, eps):
    """Per-row kernel argmax — identical math to sinkhorn._argmax_kernel_rows."""
    from cmtci.transport.sinkhorn import _pairwise_dist

    d = _pairwise_dist(rows, b_all) / mean
    k = jnp.nan_to_num(jnp.exp(-d / eps))
    return jnp.argmax(k, axis=1)


def sharded_argmax_match(ax, by, eps: float, mesh: Mesh, chunk: int = 2048):
    """Kernel-argmax OT matcher with the C rows sharded over the mesh.

    The tracker's true multi-chip hot spot (O(n·m) at 37820×150000,
    gi_assumption_tracker_v3.py:215 / tci_..._v002_fixed.py:62-71): each
    device matches its row block against the replicated M; the mean-distance
    normalizer is computed from per-chunk partial sums all_gathered in global
    chunk order and summed sequentially, so it is bitwise-identical to the
    single-device blocked matcher (sinkhorn._blocked_mean_dist accumulates
    the same chunk partials in the same order; extra all-masked pad chunks
    contribute exact 0.0). No collective touches the O(n·m) work itself.

    Returns int match indices (n,) as a host array.
    """
    ax = jnp.asarray(ax)
    by = jnp.asarray(by)
    n = ax.shape[0]
    per = chunk * mesh.devices.size
    npad = ((n + per - 1) // per) * per
    ap = jnp.pad(ax, ((0, npad - n), (0, 0)))
    out = _sharded_argmax_match_dev(ap, by, n, eps, mesh, chunk)
    return np.asarray(out)[:n]


def _sharded_argmax_match_dev(ap, by, n: int, eps, mesh: Mesh, chunk: int):
    """Device core of sharded_argmax_match (ap pre-padded to chunk*n_dev)."""
    from cmtci.transport.sinkhorn import _pairwise_dist

    n_dev = mesh.devices.size
    npad = ap.shape[0]
    rows_per = npad // n_dev
    k_loc = rows_per // chunk
    m = by.shape[0]

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("data", None), P(None, None)),
        out_specs=P("data"), check_vma=False,
    )
    def run(a_loc, b_all):
        dev = jax.lax.axis_index("data")
        row0 = dev * rows_per

        def part_body(i, parts):
            rows = jax.lax.dynamic_slice_in_dim(a_loc, i * chunk, chunk, axis=0)
            gidx = row0 + i * chunk + jnp.arange(chunk)
            d = _pairwise_dist(rows, b_all)
            d = jnp.where((gidx < n)[:, None], d, 0.0)
            return parts.at[i].set(jnp.sum(d))

        parts = jax.lax.fori_loop(0, k_loc, part_body, jnp.zeros(k_loc, a_loc.dtype))
        all_parts = jax.lax.all_gather(parts, "data", tiled=True)
        total = jax.lax.fori_loop(
            0, n_dev * k_loc, lambda i, acc: acc + all_parts[i],
            jnp.zeros((), a_loc.dtype),
        )
        mean = total / (n * m)

        # int32 always: sizes here are far below 2^31 (match VALUES are
        # unchanged)
        idx_dtype = jnp.int32

        def match_body(i, out):
            rows = jax.lax.dynamic_slice_in_dim(a_loc, i * chunk, chunk, axis=0)
            mt = _match_core(rows, b_all, mean, eps).astype(idx_dtype)
            return jax.lax.dynamic_update_slice_in_dim(out, mt, i * chunk, axis=0)

        out = jnp.zeros(rows_per, dtype=idx_dtype)
        return jax.lax.fori_loop(0, k_loc, match_body, out)

    return run(ap, by)


def sharded_de_tci_field(domain, grid_n: int, mesh: Mesh, max_iter: int = 250,
                         escape_r: float = 250.0, eps: float = 1e-12,
                         dtype=jnp.float64, grid=None):
    """(esc, d) of the TCI DE grid with rows sharded over the mesh.

    Coordinates are built once by the single-device complex_grid and
    row-sharded, so every pixel's orbit arithmetic (elementwise, no
    cross-pixel reductions) is bitwise-identical to
    kernels.mandelbrot.de_field_tci. Returns host arrays (grid_n, grid_n).
    Callers that already hold the (cr, ci) grid pass it via `grid=` to skip
    the rebuild.
    """
    if grid is not None:
        cr, ci = grid
    else:
        # build on the mesh's own platform (a CPU mesh in a GPU session
        # keeps its grid on the host)
        with jax.default_device(mesh.devices.flat[0]):
            cr, ci = mb.complex_grid(domain, grid_n, grid_n, dtype=dtype)
    n_dev = mesh.devices.size
    ny = cr.shape[0]
    npad = ((ny + n_dev - 1) // n_dev) * n_dev
    crp = jnp.pad(cr, ((0, npad - ny), (0, 0)))
    cip = jnp.pad(ci, ((0, npad - ny), (0, 0)))

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("data", None), P("data", None)),
        out_specs=(P("data", None), P("data", None)), check_vma=False,
    )
    def run(cr_loc, ci_loc):
        esc, d, _, _ = mb.de_field_tci(cr_loc, ci_loc, max_iter=max_iter,
                                       escape_r=escape_r, eps=eps)
        return esc, d

    esc, d = run(crp, cip)
    return np.asarray(esc)[:ny], np.asarray(d)[:ny]


def _masked_quantile(vals, mask, q):
    """np.quantile(vals[mask], q) with linear interpolation, fixed shapes.

    Precondition: mask selects at least one element. With an all-false mask
    the indices are clamped into range and the result is the +inf sentinel
    (NOT a silent garbage value) — callers must surface cnt==0 themselves;
    tracker_train_step returns n_escaped for exactly that assertion (the
    single-device path raises 'No escape points' on the host instead).
    """
    v = jnp.sort(jnp.where(mask, vals, jnp.inf))
    cnt = jnp.sum(mask, dtype=jnp.int32)
    pos = q * jnp.maximum(cnt - 1, 0).astype(vals.dtype)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, vals.shape[0] - 1)
    hi = jnp.clip(jnp.ceil(pos).astype(jnp.int32), 0, vals.shape[0] - 1)
    frac = pos - lo.astype(vals.dtype)
    # frac==0 ⇒ take v[lo] exactly (avoids inf*0=nan on the empty-mask sentinel)
    return jnp.where(frac > 0, v[lo] * (1.0 - frac) + v[hi] * frac, v[lo])


def _rotation_align(x0r, x0i, y0r, y0i):
    """Optimal rotation angle aligning centered x onto centered y (2-D).

    Closed-form orthogonal Procrustes in the proper-rotation case
    (R = U V^T of svd(X0^T Y0), tci_construct_mandelbrot_v002_fixed.py:73-78
    "fixed" convention): theta maximizing tr(R^T X0^T Y0).
    """
    a = jnp.sum(x0r * y0r + x0i * y0i)
    b = jnp.sum(x0r * y0i - x0i * y0r)
    return jnp.arctan2(b, a)


def _hist_prob(xr, xi, bins: int, domain, sigma_bins: float, eps, mesh: Mesh):
    """Point-sharded mollified probability histogram (device, jit-friendly)."""
    from cmtci.transport.histogram import gaussian_filter_nearest

    n_dev = mesh.devices.size
    n = xr.shape[0]
    npad = ((n + n_dev - 1) // n_dev) * n_dev
    xr = jnp.pad(xr, (0, npad - n), constant_values=domain[1] + 1.0)
    xi = jnp.pad(xi, (0, npad - n), constant_values=domain[3] + 1.0)
    h = sharded_histogram(xr, xi, bins, domain, mesh)
    h = jnp.maximum(h, eps)
    if sigma_bins and sigma_bins > 0:
        h = gaussian_filter_nearest(h, float(sigma_bins))
        h = jnp.maximum(h, eps)
    return h / h.sum()


def host_tracker_cloud(ns, family: str = "lucas_all_ones",
                       dtype=jnp.float32):
    """Inverse-eigenvalue cloud for tracker_train_step(cloud=...).

    Runs the f64 Aberth eigensweep outside the step and returns flat
    (re, im, valid) arrays cast to `dtype`, so the step itself traces no
    eigensweep.
    """

    ir, ii, valid = companion.inverse_cloud_padded(ns, family)
    vflat = np.asarray(valid).reshape(-1)
    cr = np.where(vflat, np.asarray(ir).reshape(-1), 0.0).astype(dtype)
    ci = np.where(vflat, np.asarray(ii).reshape(-1), 0.0).astype(dtype)
    return jnp.asarray(cr), jnp.asarray(ci), jnp.asarray(vflat)


def tracker_train_step(mesh: Mesh, ns, domain, grid_n: int, n_samples: int,
                       bins: int, key, max_iter: int = 64, escape_r: float = 250.0,
                       sinkhorn_eps: float = 0.8, sigma_bins: float = 1.0,
                       alpha: float = 0.1, t_steps: int = 5, eps: float = 1e-12,
                       chunk: int = 256, dtype=jnp.float32, cloud=None):
    """The REAL tracker stage as one jittable multi-chip step.

    Genuine sample -> match -> Procrustes -> mollify -> GI-flow
    (gi_assumption_tracker_v3.py:212-247), all fixed-shape on device:

      * eigensweep batch-sharded over the mesh (C cloud),
      * TCI DE grid row-sharded; escaped & d<=q25 selection as a mask;
        subsample-without-replacement via Gumbel top-k (the jit analogue of
        the host rng.choice),
      * kernel-argmax matcher with C rows sharded vs replicated M,
      * rotation-Procrustes from psum-able moments (closed-form 2x2),
      * mollified histograms point-sharded + psum, GI-flow on the replicated
        histograms.

    Returns a dict of scalar diagnostics. Host-RNG bitwise-parity runs go
    through run_tracker(mesh=...) instead; this is the fixed-shape training
    step the driver dry-runs over N virtual devices.

    Pass cloud=(re, im, valid) flat arrays from host_tracker_cloud(ns) (with
    dtype=float32) and every traced device op is f32/i32 — no f64
    eigensweep or escape loop compiles on the mesh (asserted by
    tests/test_sharded_tracker.py's jaxpr scan). cloud=None runs the
    batch-sharded f64 eigensweep in-step.

    Callers must check the returned n_escaped > 0: with no escaped pixels
    the q25 quantile is the +inf sentinel and the Gumbel sample degrades to
    unescaped pixels (the single-device path raises on the host instead).
    """
    from cmtci.transport.giflow import _kl_jit

    # 1. C cloud: precomputed, or batch-sharded eigensweep -> padded
    #    inverse cloud
    if cloud is not None:
        cr_pts, ci_pts, vflat = cloud
        cr_pts = jnp.asarray(cr_pts).astype(dtype)
        ci_pts = jnp.asarray(ci_pts).astype(dtype)
        vflat = jnp.asarray(vflat)
    else:
        zr, zi, valid = sharded_eigensweep(ns, mesh=mesh)
        ir, ii = cplx.reciprocal((zr, zi))
        vflat = valid.reshape(-1)
        cr_pts = jnp.where(vflat, ir.reshape(-1), 0.0).astype(dtype)
        ci_pts = jnp.where(vflat, ii.reshape(-1), 0.0).astype(dtype)

    # 2. M sample: row-sharded TCI DE grid, quantile band, Gumbel top-k
    n_dev = mesh.devices.size
    gpad = ((grid_n + n_dev - 1) // n_dev) * n_dev
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (grid_n - 1)
    dy = (ymax - ymin) / (grid_n - 1)
    rows_per = gpad // n_dev

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(),
        out_specs=(P("data", None), P("data", None)), check_vma=False,
    )
    def de_grid():
        idx = jax.lax.axis_index("data")
        rows = (idx * rows_per + jnp.arange(rows_per, dtype=dtype))
        cols = jnp.arange(grid_n, dtype=dtype)
        cr = jnp.broadcast_to(xmin + cols[None, :] * dx, (rows_per, grid_n)).astype(dtype)
        ci = jnp.broadcast_to((ymin + rows[:, None] * dy).astype(dtype), (rows_per, grid_n))
        esc, d, _, _ = mb.de_field_tci(cr, ci, max_iter=max_iter, escape_r=escape_r, eps=eps)
        return esc, d

    esc, d = de_grid()
    gy = jnp.repeat(jnp.arange(gpad, dtype=dtype), grid_n)
    gx = jnp.tile(jnp.arange(grid_n, dtype=dtype), gpad)
    escf = esc.reshape(-1) & (gy < grid_n)
    df = d.reshape(-1)
    q = _masked_quantile(df, escf, 0.25)
    sel = escf & (df <= q)

    if n_samples > escf.shape[0] or n_samples > vflat.shape[0]:
        raise ValueError(
            f"tracker_train_step: n_samples={n_samples} exceeds the pixel "
            f"({escf.shape[0]}) or root-lane ({vflat.shape[0]}) pool — the "
            "Gumbel top-k would select masked entries")
    k1, k2 = jax.random.split(key)
    g1 = jax.random.gumbel(k1, sel.shape, dtype=jnp.float32)
    # band points first; escaped-but-outside-band points fill any remainder
    # (if the d<=q25 band holds fewer than n_samples pixels). Contract: the
    # ESCAPED pool itself must hold >= n_samples pixels — with fewer, -inf
    # lanes (unescaped/padding pixels) would enter the sample; that count is
    # dynamic under jit, so callers size n_samples from the returned
    # n_escaped diagnostic (likewise n_valid_roots for the C side). Gumbel
    # values are ~[-3, 20+] at these sizes; +1e4 strictly separates the
    # tiers.
    score = jnp.where(sel, g1 + 1e4, jnp.where(escf, g1, -jnp.inf))
    _, midx = jax.lax.top_k(score, n_samples)
    mxr = (xmin + gx[midx] * dx).astype(dtype)
    mxi = (ymin + gy[midx] * dy).astype(dtype)

    # 3. C subsample to the matcher size (Gumbel top-k over valid lanes)
    g2 = jax.random.gumbel(k2, vflat.shape, dtype=jnp.float32)
    _, cidx = jax.lax.top_k(jnp.where(vflat, g2, -jnp.inf), n_samples)
    cxr = cr_pts[cidx]
    cxi = ci_pts[cidx]

    # 4. kernel-argmax matcher, C rows sharded vs replicated M
    per = chunk * n_dev
    npad = ((n_samples + per - 1) // per) * per
    ap = jnp.pad(jnp.stack([cxr, cxi], axis=1), ((0, npad - n_samples), (0, 0)))
    match = _sharded_argmax_match_dev(
        ap, jnp.stack([mxr, mxi], axis=1), n_samples, sinkhorn_eps, mesh, chunk
    )[:n_samples]
    myr = mxr[match]
    myi = mxi[match]

    # 5. Procrustes (rotation + translation, closed-form 2x2)
    cmr, cmi = jnp.mean(cxr), jnp.mean(cxi)
    mmr, mmi = jnp.mean(myr), jnp.mean(myi)
    x0r, x0i = cxr - cmr, cxi - cmi
    y0r, y0i = myr - mmr, myi - mmi
    th = _rotation_align(x0r, x0i, y0r, y0i)
    ct, st = jnp.cos(th), jnp.sin(th)
    axr = x0r * ct - x0i * st + mmr
    axi = x0r * st + x0i * ct + mmi

    # 6. mollified histograms (point-sharded, psum) + GI-flow
    p_m = _hist_prob(mxr, mxi, bins, domain, sigma_bins, eps, mesh)
    p_c = _hist_prob(axr, axi, bins, domain, sigma_bins, eps, mesh)
    kl0 = _kl_jit(p_m, p_c, eps)

    def gi_body(x, _):
        return (1.0 - alpha) * x + alpha * p_m, None

    x_t, _ = jax.lax.scan(gi_body, p_c, None, length=t_steps)
    delta = _kl_jit(p_m, x_t, eps)
    tv = 0.5 * jnp.sum(jnp.abs(x_t - p_m))
    tv_pc_pm = 0.5 * jnp.sum(jnp.abs(p_c - p_m))
    overlap = jnp.sum(jnp.minimum(p_c, p_m))
    return {
        "kl_initial": kl0, "delta_n": delta, "tv_XT_PM": tv,
        "tv_PC_PM": tv_pc_pm, "overlap_mass_PC_PM": overlap,
        "n_escaped": jnp.sum(escf, dtype=jnp.int32), "q25": q,
        # callers check n_samples <= n_escaped / n_valid_roots (the dynamic
        # halves of the top-k contract documented at the sampler above)
        "n_valid_roots": jnp.sum(vflat, dtype=jnp.int32),
    }


def analysis_step(ns, domain, grid_n: int, bins: int, max_iter: int, mesh: Mesh,
                  alpha: float = 0.1, gi_steps: int = 5, eps: float = 1e-12):
    """Full sharded analysis step (the dry-run "training step").

    eigensweep (batch-sharded) -> inverse cloud histogram (point-sharded,
    psum) -> dwell grid (row-sharded) -> escape-proxy histogram -> GI-flow
    on the replicated histograms. Returns dict of small diagnostics.
    """
    zr, zi, valid = sharded_eigensweep(ns, mesh=mesh)
    inv_r, inv_i = cplx.reciprocal((zr, zi))
    # mask invalid lanes to a point outside the domain so they drop from hists
    inv_r = jnp.where(valid, inv_r, domain[1] + 1.0)
    inv_i = jnp.where(valid, inv_i, domain[3] + 1.0)
    n_dev = mesh.devices.size
    flat_r = inv_r.reshape(-1)
    flat_i = inv_i.reshape(-1)
    # pad UP to a device multiple with the same out-of-domain sentinels
    # (truncating dropped up to n_dev-1 valid roots and made the histogram
    # mesh-size dependent)
    m = ((flat_r.shape[0] + n_dev - 1) // n_dev) * n_dev
    flat_r = jnp.pad(flat_r, (0, m - flat_r.shape[0]),
                     constant_values=domain[1] + 1.0)
    flat_i = jnp.pad(flat_i, (0, m - flat_i.shape[0]),
                     constant_values=domain[3] + 1.0)
    p_c = sharded_histogram(flat_r, flat_i, bins, domain, mesh)
    p_c = jnp.maximum(p_c, eps)
    p_c = p_c / p_c.sum()

    dwell = sharded_dwell_grid(domain, grid_n, grid_n, max_iter, mesh)
    esc = dwell < max_iter
    xs = jnp.linspace(domain[0], domain[1], grid_n)
    ys = jnp.linspace(domain[2], domain[3], grid_n)
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
    # exterior-proxy histogram (keep shapes static: weight by escape mask)
    wr = jnp.where(esc, gx.astype(dwell.dtype), domain[1] + 1.0)
    wi = jnp.where(esc, gy.astype(dwell.dtype), domain[3] + 1.0)
    fr = wr.reshape(-1)
    fi = wi.reshape(-1)
    m2 = ((fr.shape[0] + n_dev - 1) // n_dev) * n_dev
    fr = jnp.pad(fr, (0, m2 - fr.shape[0]), constant_values=domain[1] + 1.0)
    fi = jnp.pad(fi, (0, m2 - fi.shape[0]), constant_values=domain[3] + 1.0)
    p_m = sharded_histogram(fr, fi, bins, domain, mesh)
    p_m = jnp.maximum(p_m, eps)
    p_m = p_m / p_m.sum()

    def gi_body(x, _):
        return (1.0 - alpha) * x + alpha * p_m, None

    x_t, _ = jax.lax.scan(gi_body, p_c, None, length=gi_steps)
    p_cl = jnp.clip(p_m, eps, None)
    x_cl = jnp.clip(x_t, eps, None)
    kl = jnp.sum(p_cl * (jnp.log(p_cl) - jnp.log(x_cl)))
    return {"kl": kl, "escaped_frac": jnp.mean(esc.astype(jnp.float32)),
            "n_roots": jnp.sum(valid)}
