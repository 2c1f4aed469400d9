"""Empirical semivariograms, cross-variograms, model fits, detrending (T4-T8).

Reference behavior (reimplemented for the device):
  * grid-field semivariogram: subsample <=15k pixels, all-pairs binned mean
    of 0.5*(dV)² — variograms_construct_mandelbrot.py:178-252
  * cross-semivariogram with two independent location subsamples — :254-315
  * pdist-based point/field variograms + range-at-90% estimator —
    Iterative_Variogram_Laplacian.py:53-100
  * exponential model fit by 200-round coordinate search —
    variograms_construct_mandelbrotv2.py:206-235
  * total-degree-2 polynomial detrend — variograms_construct_mandelbrotv2.py:179-204

DELIBERATE CHANGE vs reference: the reference caps each bin at
max_pairs_per_bin pairs chosen by RNG in chunk order — a nondeterministic,
order-biased subsample that exists only to bound CPU cost. Here every pair
is used (deterministic, unbiased, cheap on the device); expected values agree, the
reference's cap noise does not reproduce. Recorded per SURVEY.md §7.3.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("nbins", "chunk", "upper"))
def _binned_sq_diff(c1, v1, c2, v2, edges, nbins: int, chunk: int, upper: bool):
    """Per-bin (sum, count) of (v1_i - v2_j)² over pairs, blocked over i.

    upper=True restricts to j > i (same-set semivariogram, no diagonal);
    upper=False uses all (i, j) pairs (cross-variogram).
    """
    n1 = c1.shape[0]
    npad = ((n1 + chunk - 1) // chunk) * chunk
    c1p = jnp.pad(c1, ((0, npad - n1), (0, 0)))
    v1p = jnp.pad(v1, (0, npad - n1))
    n2 = c2.shape[0]
    cols = jnp.arange(n2)

    def body(i, acc):
        sums, counts = acc
        blk_c = jax.lax.dynamic_slice_in_dim(c1p, i * chunk, chunk, axis=0)
        blk_v = jax.lax.dynamic_slice_in_dim(v1p, i * chunk, chunk)
        ridx = i * chunk + jnp.arange(chunk)
        d = jnp.sqrt(jnp.sum((blk_c[:, None, :] - c2[None, :, :]) ** 2, axis=-1))
        dv2 = (blk_v[:, None] - v2[None, :]) ** 2
        valid = jnp.broadcast_to(ridx[:, None] < n1, d.shape)
        if upper:
            valid = valid & (cols[None, :] > ridx[:, None])
        b = jnp.searchsorted(edges, d.ravel(), side="right") - 1
        ok = valid.ravel() & (b >= 0) & (b < nbins) & (d.ravel() >= edges[0])
        b = jnp.where(ok, b, nbins)
        sums = sums.at[b].add(jnp.where(ok, dv2.ravel(), 0.0))
        counts = counts.at[b].add(ok.astype(sums.dtype))
        return sums, counts

    init = (jnp.zeros(nbins + 1, dtype=v1.dtype), jnp.zeros(nbins + 1, dtype=v1.dtype))
    sums, counts = jax.lax.fori_loop(0, npad // chunk, body, init)
    return sums[:-1], counts[:-1]


@functools.partial(jax.jit, static_argnames=("nbins", "chunk", "upper"))
def _binned_sq_diff_masked(c1, v1, c2, v2, edges, nbins: int, chunk: int,
                           upper: bool):
    """Scatter-free variant of _binned_sq_diff for the device path.

    Scatter-adds serialize on duplicate indices, so the binning is
    reformulated as nbins+1 CUMULATIVE masked reductions (S_k = sum of dv²
    over pairs with d < edges[k]); per-bin values are adjacent differences —
    identical bin semantics to searchsorted(side="right")-1 (edges[k] <= d <
    edges[k+1]). Dense reductions instead of scatter. Counts accumulate in exact int32 (the f32 scatter path rounds counts
    near 2^24), so counts are EXACT here at any dtype; only the dv² sums
    carry f32 accumulation error (~1e-3, inside the subsample noise).
    """
    n1 = c1.shape[0]
    npad = ((n1 + chunk - 1) // chunk) * chunk
    c1p = jnp.pad(c1, ((0, npad - n1), (0, 0)))
    v1p = jnp.pad(v1, (0, npad - n1))
    n2 = c2.shape[0]
    cols = jnp.arange(n2)

    def body(i, acc):
        s_acc, n_acc = acc
        blk_c = jax.lax.dynamic_slice_in_dim(c1p, i * chunk, chunk, axis=0)
        blk_v = jax.lax.dynamic_slice_in_dim(v1p, i * chunk, chunk)
        ridx = i * chunk + jnp.arange(chunk)
        d = jnp.sqrt(jnp.sum((blk_c[:, None, :] - c2[None, :, :]) ** 2, axis=-1))
        dv2 = (blk_v[:, None] - v2[None, :]) ** 2
        valid = jnp.broadcast_to(ridx[:, None] < n1, d.shape)
        if upper:
            valid = valid & (cols[None, :] > ridx[:, None])
        dvv = jnp.where(valid, dv2, 0.0)
        s_list, n_list = [], []
        for k in range(nbins + 1):
            m = valid & (d < edges[k])
            s_list.append(jnp.sum(jnp.where(m, dvv, 0.0)))
            n_list.append(jnp.sum(m, dtype=jnp.int32))
        return s_acc + jnp.stack(s_list), n_acc + jnp.stack(n_list)

    init = (jnp.zeros(nbins + 1, dtype=v1.dtype),
            jnp.zeros(nbins + 1, dtype=jnp.int32))
    s_cum, n_cum = jax.lax.fori_loop(0, npad // chunk, body, init)
    return s_cum[1:] - s_cum[:-1], n_cum[1:] - n_cum[:-1]


def grid_semivariogram(field, gx, gy, r_bins, m_target: int = 15000, rng=None,
                       chunk: int = 1024, dtype=None):
    """Isotropic empirical semivariogram of a grid field.

    Matches variograms_construct_mandelbrot.py:178-252 up to the documented
    removal of the per-bin pair cap. Returns (r_centers, gamma, counts).

    dtype=jnp.float32 runs the all-pairs binning on the default device via
    the scatter-free masked-reduction kernel (_binned_sq_diff_masked);
    per-bin f32 sum error is ~1e-4 relative (counts are exact int32), far
    below the location-subsample noise. The f64 default keeps the scatter
    form.
    """

    field = np.asarray(field)
    coords = np.column_stack([np.asarray(gx).ravel(), np.asarray(gy).ravel()])
    vals = field.ravel()
    r = rng if rng is not None else np.random
    m = min(m_target, coords.shape[0])
    idx = r.choice(coords.shape[0], size=m, replace=False)
    c = jnp.asarray(coords[idx], dtype)
    v = jnp.asarray(vals[idx], dtype)
    edges = jnp.asarray(np.asarray(r_bins, dtype=float), dtype)
    nbins = len(r_bins) - 1
    binned = _binned_sq_diff_masked if dtype is not None else _binned_sq_diff
    sums, counts = binned(c, v, c, v, edges, nbins, chunk, upper=True)
    sums, counts = np.asarray(sums), np.asarray(counts)
    gamma = np.zeros(nbins)
    nz = counts > 0
    gamma[nz] = 0.5 * sums[nz] / counts[nz]
    r_centers = 0.5 * (np.asarray(r_bins)[:-1] + np.asarray(r_bins)[1:])
    return r_centers, gamma, counts


def cross_semivariogram(field1, field2, gx, gy, r_bins, m_target: int = 15000,
                        rng=None, chunk: int = 1024, dtype=None):
    """Cross-semivariogram with independent location subsamples (:254-315)."""

    coords = np.column_stack([np.asarray(gx).ravel(), np.asarray(gy).ravel()])
    v1 = np.asarray(field1).ravel()
    v2 = np.asarray(field2).ravel()
    r = rng if rng is not None else np.random
    m = min(m_target, coords.shape[0])
    i1 = r.choice(coords.shape[0], size=m, replace=False)
    i2 = r.choice(coords.shape[0], size=m, replace=False)
    edges = jnp.asarray(np.asarray(r_bins, dtype=float), dtype)
    nbins = len(r_bins) - 1
    binned = _binned_sq_diff_masked if dtype is not None else _binned_sq_diff
    sums, counts = binned(
        jnp.asarray(coords[i1], dtype), jnp.asarray(v1[i1], dtype),
        jnp.asarray(coords[i2], dtype), jnp.asarray(v2[i2], dtype),
        edges, nbins, chunk, upper=False,
    )
    sums, counts = np.asarray(sums), np.asarray(counts)
    gamma = np.zeros(nbins)
    nz = counts > 0
    gamma[nz] = 0.5 * sums[nz] / counts[nz]
    r_centers = 0.5 * (np.asarray(r_bins)[:-1] + np.asarray(r_bins)[1:])
    return r_centers, gamma, counts


@functools.partial(jax.jit, static_argnames=("nbins", "chunk"))
def _binned_three_masked(cc, vc, cm, vm, c1, v1, c2, v2, edges, nbins: int,
                         chunk: int):
    """The variogram pipeline's three binnings in ONE compiled call.

    γ_C, γ_M (upper-triangle self pairs) and the cross variogram (full
    rectangle, independent subsamples) — identical math to three separate
    _binned_sq_diff_masked dispatches, fused into one dispatch + one packed
    fetch instead of three dispatches and six fetches."""
    s_c, n_c = _binned_sq_diff_masked(cc, vc, cc, vc, edges, nbins, chunk, True)
    s_m, n_m = _binned_sq_diff_masked(cm, vm, cm, vm, edges, nbins, chunk, True)
    s_x, n_x = _binned_sq_diff_masked(c1, v1, c2, v2, edges, nbins, chunk, False)
    if s_c.dtype == jnp.float32:
        # bitcast keeps the int32 counts EXACT through the single packed
        # f32 fetch (astype(f32) rounds counts above 2^24 — ~17M pairs per
        # bin, reached at the default m_target=15000 with broad bins);
        # the host side views these rows back as int32
        pack = lambda c: jax.lax.bitcast_convert_type(c, jnp.float32)  # noqa: E731
    else:
        pack = lambda c: c.astype(s_c.dtype)  # f64 is exact for any int32  # noqa: E731
    return jnp.stack([s_c, pack(n_c), s_m, pack(n_m), s_x, pack(n_x)])


def three_semivariograms(field_c, field_m, gx, gy, r_bins, m_target: int = 15000,
                         rng=None, chunk: int = 1024, dtype=None, mesh=None):
    """(γ_C, γ_M, γ_cross) with the pipeline's exact RNG draw order.

    Draws the four location subsamples in the same host-RNG order as the
    sequential grid_semivariogram/grid_semivariogram/cross_semivariogram
    calls (idx_C, idx_M, i1, i2), then runs all three binnings in one
    device call (f32 path) or falls back to the sequential host path.
    With `mesh` (a jax.sharding.Mesh) the three binnings shard their i-rows
    over the mesh (parallel.sharded.sharded_binned_sq_diff — counts
    EXACTLY equal to the host path, sums to f64 reduction order).
    Returns (r_centers, gamma_c, gamma_m, gamma_x, counts_c, counts_m,
    counts_x)."""
    if mesh is not None:
        from cmtci.parallel.sharded import sharded_binned_sq_diff

        coords = np.column_stack([np.asarray(gx).ravel(),
                                  np.asarray(gy).ravel()])
        vc_all = np.asarray(field_c).ravel()
        vm_all = np.asarray(field_m).ravel()
        r = rng if rng is not None else np.random
        m = min(m_target, coords.shape[0])
        idx_c = r.choice(coords.shape[0], size=m, replace=False)
        idx_m = r.choice(coords.shape[0], size=m, replace=False)
        i1 = r.choice(coords.shape[0], size=m, replace=False)
        i2 = r.choice(coords.shape[0], size=m, replace=False)
        nbins = len(r_bins) - 1
        s_c, n_c = sharded_binned_sq_diff(
            coords[idx_c], vc_all[idx_c], coords[idx_c], vc_all[idx_c],
            r_bins, mesh, upper=True, chunk=chunk // 2, dtype=dtype)
        s_m, n_m = sharded_binned_sq_diff(
            coords[idx_m], vm_all[idx_m], coords[idx_m], vm_all[idx_m],
            r_bins, mesh, upper=True, chunk=chunk // 2, dtype=dtype)
        s_x, n_x = sharded_binned_sq_diff(
            coords[i1], vc_all[i1], coords[i2], vm_all[i2],
            r_bins, mesh, upper=False, chunk=chunk // 2, dtype=dtype)

        def gamma_of(sums, counts):
            g = np.zeros(nbins)
            nz = counts > 0
            g[nz] = 0.5 * sums[nz] / counts[nz]
            return g

        r_centers = 0.5 * (np.asarray(r_bins)[:-1] + np.asarray(r_bins)[1:])
        return (r_centers, gamma_of(s_c, n_c), gamma_of(s_m, n_m),
                gamma_of(s_x, n_x), n_c, n_m, n_x)
    if dtype is None:
        r_c, g_c, n_c = grid_semivariogram(field_c, gx, gy, r_bins, m_target,
                                           rng, chunk, dtype)
        _, g_m, n_m = grid_semivariogram(field_m, gx, gy, r_bins, m_target,
                                         rng, chunk, dtype)
        _, g_x, n_x = cross_semivariogram(field_c, field_m, gx, gy, r_bins,
                                          m_target, rng, chunk, dtype)
        return r_c, g_c, g_m, g_x, n_c, n_m, n_x
    coords = np.column_stack([np.asarray(gx).ravel(), np.asarray(gy).ravel()])
    vc_all = np.asarray(field_c).ravel()
    vm_all = np.asarray(field_m).ravel()
    r = rng if rng is not None else np.random
    m = min(m_target, coords.shape[0])
    idx_c = r.choice(coords.shape[0], size=m, replace=False)
    idx_m = r.choice(coords.shape[0], size=m, replace=False)
    i1 = r.choice(coords.shape[0], size=m, replace=False)
    i2 = r.choice(coords.shape[0], size=m, replace=False)
    nbins = len(r_bins) - 1
    edges = jnp.asarray(np.asarray(r_bins, dtype=float), dtype)
    packed = np.asarray(_binned_three_masked(
        jnp.asarray(coords[idx_c], dtype), jnp.asarray(vc_all[idx_c], dtype),
        jnp.asarray(coords[idx_m], dtype), jnp.asarray(vm_all[idx_m], dtype),
        jnp.asarray(coords[i1], dtype), jnp.asarray(vc_all[i1], dtype),
        jnp.asarray(coords[i2], dtype), jnp.asarray(vm_all[i2], dtype),
        edges, nbins, chunk))

    def gamma_of(sums, counts):
        g = np.zeros(nbins)
        nz = counts > 0
        g[nz] = 0.5 * sums[nz] / counts[nz]
        return g

    if packed.dtype == np.float32:  # exact int32 counts bitcast through f32
        unpack = lambda row: row.view(np.int32)  # noqa: E731
    else:
        unpack = lambda row: row.astype(np.int64)  # noqa: E731
    n_c, n_m, n_x = unpack(packed[1]), unpack(packed[3]), unpack(packed[5])
    if (int(n_c.sum()) + int(n_m.sum()) + int(n_x.sum()) == 0
            and bool(np.any(packed[[0, 2, 4]] != 0))):
        # tripwire for a corrupt device result (see _point_binned_masked):
        # zero counts WITH nonzero dv² sums is
        # impossible legitimately (every summed pair is counted by the
        # same mask) — it is the corrupt-fetch signature, while genuinely
        # empty bins (caller's r_bins off the distance support) zero both
        raise RuntimeError(
            "three_semivariograms: all per-bin counts fetched as zero while "
            "the dv² sums are nonzero — corrupt device fetch, not empty "
            "bins; rerun with dtype=None for the f64 path")
    r_centers = 0.5 * (np.asarray(r_bins)[:-1] + np.asarray(r_bins)[1:])
    g_c = gamma_of(packed[0].astype(np.float64), n_c)
    g_m = gamma_of(packed[2].astype(np.float64), n_m)
    g_x = gamma_of(packed[4].astype(np.float64), n_x)
    return r_centers, g_c, g_m, g_x, n_c, n_m, n_x


_TRIU_CACHE: dict = {}


def _triu_pairs(n: int):
    """Cached np.triu_indices(n, k=1) — the coupling loop re-derives the
    same 744k-pair index every iteration; one entry is kept (LRU-1) so
    repeated cloud sizes stop paying the 27 ms triangular scan. Only sizes
    up to ~4M pairs (64 MB of int64 indices) are cached: a single 20k-point
    call would otherwise pin ~3.2 GB for the life of the process to save a
    fraction of that call's own O(n²) work."""
    hit = _TRIU_CACHE.get(n)
    if hit is None:
        pairs = np.triu_indices(n, k=1)
        if n * (n - 1) // 2 <= 4_000_000:
            _TRIU_CACHE.clear()
            _TRIU_CACHE[n] = pairs
        return pairs
    return hit


def point_variogram(locs, values=None, max_dist=None, nbins: int = 50):
    """pdist-style variogram (Iterative_Variogram_Laplacian.py:53-87).

    values=None uses squared pairwise distances as the 'field difference'
    (the reference's coords-only variant). Returns (centers, gamma, counts).
    """
    locs = np.asarray(locs, dtype=float)
    n = len(locs)
    i, j = _triu_pairs(n)
    d = np.linalg.norm(locs[i] - locs[j], axis=1)
    sq = d**2 if values is None else (np.asarray(values)[i] - np.asarray(values)[j]) ** 2
    if max_dist is None:
        max_dist = 0.5 * d.max() if d.size else 1.0
    bins = np.linspace(0, max_dist, nbins + 1)
    centers = 0.5 * (bins[:-1] + bins[1:])
    gamma = np.full(nbins, np.nan)
    counts = np.zeros(nbins, dtype=int)
    which = np.digitize(d, bins) - 1
    # one stable sort instead of nbins boolean scans (O(P log P) vs
    # O(nbins*P); 0.18 s -> 0.02 s per coupling iteration at 744k pairs).
    # BITWISE-identical to the masked loop: a stable sort keeps ascending
    # index order inside each bin, so np.mean sees the same values in the
    # same order through the same pairwise add.reduce.
    order = np.argsort(which, kind="stable")
    ws = which[order]
    sq_sorted = sq[order]
    starts = np.searchsorted(ws, np.arange(nbins), side="left")
    stops = np.searchsorted(ws, np.arange(nbins), side="right")
    for k in range(nbins):
        lo, hi = starts[k], stops[k]
        if hi > lo:
            gamma[k] = 0.5 * np.mean(sq_sorted[lo:hi])
            counts[k] = hi - lo
    return centers, gamma, counts


@functools.partial(jax.jit, static_argnames=("nbins", "chunk", "use_values",
                                              "auto_max"))
def _point_binned_masked(locs, vals, max_d, nbins: int, chunk: int,
                         use_values: bool, auto_max: bool):
    """point_variogram's binning as scatter-free masked reductions.

    Same cumulative-difference reformulation as _binned_sq_diff_masked
    (bin k = edges[k] <= d < edges[k+1], the np.digitize(..)-1 semantics of
    Iterative_Variogram_Laplacian.py:53-87 — d == edges[-1] is dropped by
    both). auto_max derives the host path's default max_dist = 0.5 * d.max()
    in-graph so no extra roundtrip fetches the maximum. Returns
    ((2, nbins) stack [dv² sums, bin centers], counts int32) — counts ride
    as a separate int32 output: a bitcast-through-f32 row inside a stack
    whose other rows derive from an in-graph jnp.linspace was once measured
    to compile to zeros on an accelerator backend."""
    n = locs.shape[0]
    npad = ((n + chunk - 1) // chunk) * chunk
    lp = jnp.pad(locs, ((0, npad - n), (0, 0)))
    vp = jnp.pad(vals, (0, npad - n))
    cols = jnp.arange(n)

    def dists_block(i):
        blk = jax.lax.dynamic_slice_in_dim(lp, i * chunk, chunk, axis=0)
        ridx = i * chunk + jnp.arange(chunk)
        d = jnp.sqrt(jnp.sum((blk[:, None, :] - locs[None, :, :]) ** 2, -1))
        valid = (ridx[:, None] < n) & (cols[None, :] > ridx[:, None])
        return d, valid, ridx

    if auto_max:
        def body_max(i, acc):
            d, valid, _ = dists_block(i)
            return jnp.maximum(acc, jnp.max(jnp.where(valid, d, -jnp.inf)))

        dmax = jax.lax.fori_loop(0, npad // chunk, body_max,
                                 jnp.asarray(-jnp.inf, locs.dtype))
        max_d = jnp.asarray(0.5, locs.dtype) * dmax
    edges = jnp.linspace(jnp.asarray(0.0, locs.dtype), max_d, nbins + 1)

    def body(i, acc):
        s_acc, n_acc = acc
        d, valid, ridx = dists_block(i)
        if use_values:
            blk_v = jax.lax.dynamic_slice_in_dim(vp, i * chunk, chunk)
            dv2 = (blk_v[:, None] - vals[None, :]) ** 2
        else:
            dv2 = d * d
        dvv = jnp.where(valid, dv2, 0.0)
        # per-bin accumulation (adjacent differences of the in-block
        # cumulative masks), not cumulative: cumulative int32 counts wrap
        # at 2^31 total pairs (~65k points), per-bin wraps only when one
        # bin alone holds 2^31 pairs — guarded in the wrapper
        s_bin, n_bin = masked_bin_reduce(d, valid, edges, nbins, dvv=dvv)
        return s_acc + s_bin, n_acc + n_bin

    init = (jnp.zeros(nbins, dtype=locs.dtype),
            jnp.zeros(nbins, dtype=jnp.int32))
    sums, counts = jax.lax.fori_loop(0, npad // chunk, body, init)
    return jnp.stack([sums, 0.5 * (edges[:-1] + edges[1:])]), counts


def guard_pair_count_int32(n: int, what: str) -> None:
    """Reject clouds whose pair count can wrap the device heads' counts.

    The device pair-histogram heads accumulate SIGNED int32 per-bin counts;
    one bin can hold at most n(n-1)/2 pairs, so n = 65536 is the last safe
    size (65536*65535/2 = 2147450880 < 2^31-1). Fail loudly instead of
    wrapping negative. The host heads accumulate f64 (exact to 2^53 pairs)
    and stay unguarded. Shared by every masked-reduction pair scan
    (point_variogram_device, pointstats._shell_counts)."""
    if n > 65536:
        raise ValueError(
            f"{what}: {n} points can overflow the signed int32 per-bin "
            "pair counts (limit 65536); subsample the cloud")


def masked_bin_reduce(d, valid, edges, nbins: int, dvv=None):
    """Scatter-free per-bin pair reductions (the device pattern shared by the
    device variogram and shell-count heads): cumulative counts of
    valid & (d < edges[k]) per edge, adjacent-differenced to exact int32
    per-bin counts — bin semantics identical to searchsorted(side="right"),
    including d == edges[k] landing in bin k. With `dvv`, also returns the
    matching per-bin sums (accumulated per-bin, not cumulative, so int
    wrap needs 2^31 pairs in ONE bin — guard_pair_count_int32 in the
    wrapper). Traced inside the callers' jits; `nbins` must be static."""
    s_list, n_list = [], []
    for k in range(nbins + 1):
        m = valid & (d < edges[k])
        n_list.append(jnp.sum(m, dtype=jnp.int32))
        if dvv is not None:
            s_list.append(jnp.sum(jnp.where(m, dvv, 0.0)))
    n_cum = jnp.stack(n_list)
    counts = n_cum[1:] - n_cum[:-1]
    if dvv is None:
        return counts
    s_cum = jnp.stack(s_list)
    return s_cum[1:] - s_cum[:-1], counts


def point_variogram_device(locs, values=None, max_dist=None, nbins: int = 50,
                           chunk: int = 1024, dtype=None):
    """Device realization of point_variogram for beyond-reference scales.

    Same bin semantics as the host path (verified: counts EXACTLY equal,
    gamma within f32 accumulation error ~1e-5 relative); the O(n²) pair
    work runs as blocked masked reductions on the default device in ONE
    dispatch + one packed fetch, instead of materializing 12M-pair index
    gathers on the host. dtype=None follows x64; pass jnp.float32 (or run
    under CouplingConfig vario_dtype="float32") on a GPU session.
    Reference: Iterative_Variogram_Laplacian.py:53-87.
    """
    from cmtci.utils.device import analysis_dtype_ctx

    locs = np.asarray(locs, dtype=float)
    n = len(locs)
    if n < 2:
        centers = np.linspace(0, max_dist or 1.0, nbins + 1)
        centers = 0.5 * (centers[:-1] + centers[1:])
        return centers, np.full(nbins, np.nan), np.zeros(nbins, dtype=int)
    guard_pair_count_int32(n, "point_variogram_device")
    dt, x64_ctx = analysis_dtype_ctx(dtype)
    with x64_ctx:
        vals = (jnp.zeros(n, dt) if values is None
                else jnp.asarray(np.asarray(values), dt))
        packed, counts = _point_binned_masked(
            jnp.asarray(locs, dt), vals,
            jnp.asarray(0.0 if max_dist is None else max_dist, dt),
            int(nbins), int(chunk), use_values=values is not None,
            auto_max=max_dist is None)
        packed = np.asarray(packed)
        counts = np.asarray(counts).astype(np.int64)
    if int(counts.sum()) == 0 and bool(np.any(packed[0] != 0)):
        # same corrupt-fetch tripwire as three_semivariograms: zero counts
        # WITH nonzero dv² sums is impossible legitimately (every summed
        # pair is counted by the same mask) — it is the corrupt-result
        # signature, while genuinely empty bins zero both
        raise RuntimeError(
            "point_variogram_device: all per-bin counts fetched as zero "
            "while the dv² sums are nonzero — corrupt device fetch, not "
            "empty bins; rerun with dtype=None for the f64 path")
    gamma = np.full(nbins, np.nan)
    nz = counts > 0
    gamma[nz] = 0.5 * packed[0].astype(np.float64)[nz] / counts[nz]
    return packed[1].astype(np.float64), gamma, counts


def cross_variogram_from_matches(c, m, construct_idx, mandel_idx, nbins: int = 50,
                                 max_dist=None):
    """Matched-pair cross-variogram (Variogram-Mandelbrot-Construct.py:155-178).

    Lag = |C[ci] - M[mi]| per matched pair; semivariance = 0.5*mean(|d|²) per
    lag bin (the reference's matched-pair cross-plot statistic).
    Returns (centers, gamma, counts).
    """
    construct_idx = np.asarray(construct_idx, dtype=int)
    mandel_idx = np.asarray(mandel_idx, dtype=int)
    if len(construct_idx) == 0:
        return np.array([]), np.array([]), np.array([])
    diffs = np.asarray(c)[construct_idx] - np.asarray(m)[mandel_idx]
    mags = np.linalg.norm(diffs, axis=1)
    sq = np.sum(diffs**2, axis=1)
    if max_dist is None:
        max_dist = mags.max() if mags.size else 1.0
    bins = np.linspace(0.0, max_dist, nbins + 1)
    centers = 0.5 * (bins[:-1] + bins[1:])
    gamma = np.full(nbins, np.nan)
    counts = np.zeros(nbins, dtype=int)
    inds = np.digitize(mags, bins) - 1
    for k in range(nbins):
        mask = inds == k
        if mask.any():
            gamma[k] = 0.5 * np.mean(sq[mask])
            counts[k] = mask.sum()
    return centers, gamma, counts


def variogram_range(lags, gamma, pct: float = 0.9):
    """First lag where gamma >= pct*max (Iterative_Variogram_Laplacian.py:88-100)."""
    finite = np.isfinite(gamma)
    if not finite.any():
        return None
    thr = pct * np.nanmax(gamma)
    for lag, g in zip(lags, gamma):
        if np.isfinite(g) and g >= thr:
            return lag
    return lags[-1]


def fit_exponential_variogram(r, gamma, rounds: int = 200):
    """nugget + sill*(1-exp(-r/a)) by coordinate search (v2:206-235)."""
    r = np.asarray(r, dtype=float)
    g_in = np.asarray(gamma, dtype=float)
    m = np.isfinite(r) & np.isfinite(g_in) & (r > 0)
    if m.sum() < 5:
        return {"nugget": np.nan, "sill": np.nan, "a": np.nan, "model": None}
    r, g = r[m], g_in[m]
    params = np.array([max(0.0, g.min()), max(1e-9, g.max() - g.min()), 0.5])

    def model(p, rr):
        return p[0] + p[1] * (1.0 - np.exp(-rr / max(1e-6, p[2])))

    def loss(p):
        return np.sum((g - model(p, r)) ** 2)

    for _ in range(rounds):
        for j in range(3):
            step = 0.05 * (1.0 if j < 2 else max(0.1, params[2]))
            for s in (+1, -1):
                cand = params.copy()
                cand[j] += s * step
                if loss(cand) < loss(params):
                    params = cand
    nug, sil, a = params
    return {"nugget": float(nug), "sill": float(sil), "a": float(a),
            "model": lambda rr: nug + sil * (1.0 - np.exp(-rr / max(1e-6, a)))}


def detrend_poly2d(field, gx, gy, deg: int = 2):
    """Total-degree-deg polynomial detrend (v2:179-204). Returns (resid, fit)."""
    field = np.asarray(field)
    x = np.asarray(gx).ravel()
    y = np.asarray(gy).ravel()
    powers = [(i, j) for i in range(deg + 1) for j in range(deg + 1 - i)]
    phi = np.column_stack([(x**i) * (y**j) for (i, j) in powers])
    coef, *_ = np.linalg.lstsq(phi, field.ravel(), rcond=None)
    fit = (phi @ coef).reshape(field.shape)
    return field - fit, fit
