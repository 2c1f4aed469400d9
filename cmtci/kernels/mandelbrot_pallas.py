"""Fused Pallas escape-time kernels for the GPU (Triton route), with per-block
early exit.

The reference's hottest loop is the pure-Python per-pixel dwell grid
(mandelbrot_boundary_sample.py:22-39, res² = 4e6 pixels x <=500 iterations).
The plain XLA versions (kernels/mandelbrot.py, parallel/sharded._dwell_local)
are loops over the whole array that keep the orbit state in device memory
between iterations (~32 B of traffic per pixel per iteration against ~18
flops) and run every pixel to max_iter. Here each (TH, TW) block keeps its
orbit state in registers as `lax.while_loop` carries (the Triton route has
no scratch memory), synthesizes its complex coordinates from program_id (no
input traffic), and runs Python-unrolled chunks of `inner` iterations until
every lane of the block has escaped, so far-field blocks stop after one
chunk. Escaped lanes are NOT frozen: IEEE inf/nan propagation keeps the
`inside`/`hit` predicates false after escape, so the latched outputs stay
exact without freeze selects.

Heads (static `kind`):
  * "dwell"  — first n (0-based) with |z_{n+1}|² > 4, else max_iter
  * "green"  — g = log|z_k| * 2^-k at first escape (|z| > escape_r), else 0
    (variograms_construct_mandelbrot.py:148-166 normalization)
  * "de"     — standard distance estimator (variograms_construct_mandelbrot.py:61-88)
  * "tci"    — the TCI distance estimator (tci_construct_mandelbrot_v002_fixed.py:35-47)

float32 is the kernel path (the analysis/parity path is the float64 XLA
kernel in kernels/mandelbrot.py); dwell counts are integer-exact except for
orbits within f32 noise of the escape boundary (~0.2% of pixels).

Kernels are traced with x64 disabled so that Python-scalar constants stay
32-bit inside the kernel. On the CPU backend they run in the Pallas
interpreter (the tests); on the GPU they are compiled through Triton;
utils.device.pallas_interpret refuses any other backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from cmtci.utils.device import pallas_interpret

#: (rows, cols) of one grid block, powers of two (Triton). Chosen on an
#: H100 from a sweep of 512-8192-pixel blocks, 4/8 warps and 8/16 unrolled
#: iterations at res 2000 and 8192 (PERF.md): small blocks exit earlier,
#: and 512 pixels on 4 warps was fastest or within noise of it.
DEFAULT_TILE = (16, 32)
#: Unrolled iterations between two block-wide early-exit tests.
DEFAULT_INNER = 16
#: Points per block of the cloud Green kernel (256 beat 512-2048 there).
CLOUD_BLOCK = 256
NUM_WARPS = 4

# select operands inside the kernels are typed f32 scalars: the Triton
# lowering gives a weakly-typed Python float in a select the predicate's
# (bool) type
_ZERO = np.float32(0.0)
_ONE = np.float32(1.0)
_NEG1 = np.float32(-1.0)


def _nan_max(x, floor):
    """max(x, floor) that keeps NaN like XLA's maximum: the Triton lowering
    of jnp.maximum returns the non-NaN operand, which would turn the TCI
    head's NaN denominators into the floor and d into a huge finite value."""
    floor = np.float32(floor)  # a typed select operand: see _ZERO
    return jnp.where(x < floor, floor, x)


def _compiler_params():
    return pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def _check_tile(tile):
    th, tw = tile
    for v in (th, tw):
        if v < 1 or v & (v - 1):
            raise ValueError(f"tile {tuple(tile)} must be powers of two")
    return th, tw


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _tile_coords(params_ref, th: int, tw: int):
    i = pl.program_id(0)
    j = pl.program_id(1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0).astype(jnp.float32)
    cols = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1).astype(jnp.float32)
    cr = params_ref[0] + (cols + jnp.float32(tw) * j.astype(jnp.float32)) * params_ref[2]
    ci = params_ref[1] + (rows + jnp.float32(th) * i.astype(jnp.float32)) * params_ref[3]
    return cr, ci


def _interior_mask(cr, ci):
    """Analytic never-escapes test (cardioid + period-2 bulb, 1e-5 margin).

    The margin keeps the f32-evaluated tests strictly INSIDE the true sets
    (f32 eval error ~1e-7): near-parabolic exterior pixels with finite dwell
    ~1/sqrt(distance) are never misclassified, at any max_iter; the excluded
    interior sliver just iterates normally."""
    q = (cr - 0.25) * (cr - 0.25) + ci * ci
    in_cardioid = q * (q + (cr - 0.25)) <= 0.25 * ci * ci - 1e-5
    in_bulb = (cr + 1.0) * (cr + 1.0) + ci * ci <= 0.0625 - 1e-5
    return in_cardioid | in_bulb


def _chunked_loop(body_step, state, n_iters: int, inner: int, alive):
    """Run `body_step(state, it)` for it < n_iters in unrolled chunks of
    `inner`, stopping once `alive(state)` is false for the whole block.

    `it` is the traced int32 iteration index; a chunk may overrun past
    n_iters, so body_step must make those steps no-ops (the `it < n_iters`
    guard)."""
    n_chunks = (n_iters + inner - 1) // inner

    def body(s):
        c, st = s
        base = c * inner
        for n in range(inner):
            st = body_step(st, base + n)
        return c + 1, st

    def cond(s):
        c, st = s
        return jnp.logical_and(c < n_chunks, alive(st))

    return jax.lax.while_loop(cond, body, (jnp.int32(0), state))[1]


def _dwell_kernel(params_ref, out_ref, *, max_iter: int, inner: int):
    th, tw = out_ref.shape
    cr, ci = _tile_coords(params_ref, th, tw)
    # analytic interior lanes start inactive with dwell = max_iter, so
    # interior-dominated blocks exit after one chunk
    interior = _interior_mask(cr, ci)
    zero = jnp.zeros((th, tw), jnp.float32)

    def step(s, it):
        zr, zi, act, dwell = s
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        inside = zr * zr + zi * zi <= 4.0  # inf/nan -> False, latches act
        act = jnp.where(inside, act, _ZERO)
        # count only the first max_iter iterations
        return zr, zi, act, dwell + jnp.where(it < max_iter, act, _ZERO)

    state = (zero, zero, jnp.where(interior, _ZERO, _ONE),
             jnp.where(interior, np.float32(max_iter), _ZERO))
    out = _chunked_loop(step, state, max_iter, inner,
                        lambda s: jnp.max(s[2]) > 0.5)
    out_ref[...] = out[3]


def _green_kernel(params_ref, out_ref, *, max_iter: int, inner: int,
                  escape_r: float):
    th, tw = out_ref.shape
    cr, ci = _tile_coords(params_ref, th, tw)
    zero = jnp.zeros((th, tw), jnp.float32)
    r2 = jnp.float32(escape_r * escape_r)

    # (zr, zi, done, k, a2): k = 1-based escape iteration (0 = none), a2 =
    # |z_k|² latched there; g is formed once from (k, a2) after the loop.
    # Analytically-interior lanes start done with k = 0 -> g = 0, the exact
    # non-escape output, and let interior blocks exit after one chunk.
    def step(s, it):
        zr, zi, done, kk, la2 = s
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        a2 = zr * zr + zi * zi
        hit = (a2 > r2) & (done < 0.5) & (it < max_iter)
        kk = jnp.where(hit, (it + 1).astype(jnp.float32), kk)
        la2 = jnp.where(hit, a2, la2)
        return zr, zi, jnp.where(hit, _ONE, done), kk, la2

    state = (zero, zero, jnp.where(_interior_mask(cr, ci), _ONE, _ZERO), zero, zero)
    _, _, _, kk, la2 = _chunked_loop(step, state, max_iter, inner,
                                     lambda s: jnp.min(s[2]) < 0.5)
    g = 0.5 * jnp.log(_nan_max(la2, 1e-30)) * jnp.exp2(-kk)
    out_ref[...] = jnp.where(kk > 0.5, _nan_max(g, _ZERO), _ZERO)


def _de_kernel(params_ref, out_ref, *, max_iter: int, inner: int,
               escape_r: float):
    th, tw = out_ref.shape
    cr, ci = _tile_coords(params_ref, th, tw)
    zero = jnp.zeros((th, tw), jnp.float32)
    one = jnp.ones((th, tw), jnp.float32)
    r2 = jnp.float32(escape_r * escape_r)

    def step(s, it):
        zr, zi, esc, dzr, dzi, lzr, lzi, ldr, ldi = s
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        hit = (zr * zr + zi * zi > r2) & (esc < 0.5) & (it < max_iter)
        lzr = jnp.where(hit, zr, lzr)
        lzi = jnp.where(hit, zi, lzi)
        ldr = jnp.where(hit, dzr, ldr)
        ldi = jnp.where(hit, dzi, ldi)
        esc = jnp.where(hit, _ONE, esc)
        # freeze escaped z/dz, mirroring the latched f64 semantics
        frozen = esc > 0.5
        zr = jnp.where(frozen, _ZERO, zr)
        zi = jnp.where(frozen, _ZERO, zi)
        dzr = jnp.where(frozen, _ONE, dzr)
        dzi = jnp.where(frozen, _ZERO, dzi)
        return zr, zi, esc, dzr, dzi, lzr, lzi, ldr, ldi

    # interior lanes marked escaped with zero latches -> d = 0 exactly (the
    # reference's non-escape output), interior blocks exit after one chunk
    interior = jnp.where(_interior_mask(cr, ci), _ONE, _ZERO)
    state = (zero, zero, interior, one, zero, zero, zero, one, zero)
    out = _chunked_loop(step, state, max_iter, inner,
                        lambda s: jnp.min(s[2]) < 0.5)
    _, _, esc, _, _, lzr, lzi, ldr, ldi = out
    az = jnp.sqrt(lzr * lzr + lzi * lzi)
    pr = 2.0 * (lzr * ldr - lzi * ldi)
    pi_ = 2.0 * (lzr * ldi + lzi * ldr)
    num = jnp.log(_nan_max(az, 1.0)) * az
    den = _nan_max(jnp.sqrt(pr * pr + pi_ * pi_), 1e-14)
    out_ref[...] = jnp.where(esc > 0.5, num / den, _ZERO)


def _tci_kernel(params_ref, out_ref, *, max_iter: int, inner: int,
                escape_r: float):
    """TCI distance estimator (tci_construct_mandelbrot_v002_fixed.py:35-47).

    The reference's non-latched-dz overflow semantics: z is latched at first
    |z| > escape_r, but dz keeps iterating with the evolving z and overflows
    to inf for all but the latest escapers, so d == 0 there. Early exit is
    exact: a lane is "done" when it is analytically interior (d = 0, not
    escaped) or when it has escaped AND its dz has gone non-finite — from
    then on d = num/inf = 0 (or nan -> 0) regardless of further iterations,
    and non-finite dz can never return to finite. Late escapers with still-
    finite dz keep their block alive until max_iter, exactly like the f64
    XLA path. Output encoding: d (>= 0) where escaped, -1.0 where not.
    """
    th, tw = out_ref.shape
    cr, ci = _tile_coords(params_ref, th, tw)
    zero = jnp.zeros((th, tw), jnp.float32)
    r2 = jnp.float32(escape_r * escape_r)

    def step(s, it):
        zr, zi, escf, dzr, dzi, lzr, lzi, done = s
        # guard chunk overrun past max_iter: extra steps must not evolve
        # dz (it feeds d for late escapers) nor latch anything
        sv = it < max_iter
        tr, ti = 2.0 * zr, 2.0 * zi
        ndzr, ndzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        nzr, nzi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        dzr = jnp.where(sv, ndzr, dzr)
        dzi = jnp.where(sv, ndzi, dzi)
        zr = jnp.where(sv, nzr, zr)
        zi = jnp.where(sv, nzi, zi)
        hit = (zr * zr + zi * zi > r2) & (escf < 0.5) & sv  # inf -> True
        lzr = jnp.where(hit, zr, lzr)
        lzi = jnp.where(hit, zi, lzi)
        escf = jnp.where(hit, _ONE, escf)
        # escaped lanes keep iterating z and dz (NOT frozen) — the
        # reference's overflow-to-inf path; dz non-finite => d pinned at 0
        dz_dead = jnp.logical_not(jnp.isfinite(dzr) & jnp.isfinite(dzi))
        done = jnp.where((escf > 0.5) & dz_dead, _ONE, done)
        return zr, zi, escf, dzr, dzi, lzr, lzi, done

    interior = jnp.where(_interior_mask(cr, ci), _ONE, _ZERO)
    state = (zero, zero, zero, jnp.ones((th, tw), jnp.float32), zero, zero,
             zero, interior)
    out = _chunked_loop(step, state, max_iter, inner,
                        lambda s: jnp.min(s[7]) < 0.5)
    _, _, escf, dzr, dzi, lzr, lzi, _ = out
    az = jnp.sqrt(lzr * lzr + lzi * lzi)
    # final (possibly inf/nan) dz with the latched z, like de_field_tci
    pr = 2.0 * lzr * dzr - 2.0 * lzi * dzi
    pi_ = 2.0 * lzr * dzi + 2.0 * lzi * dzr
    den = _nan_max(jnp.sqrt(pr * pr + pi_ * pi_), 1e-12)
    # az >= escape_r where escaped, so log(max(az,1)) == log(az) there; the
    # max only protects the az == 0 lanes (never escaped), which output -1
    num = jnp.log(_nan_max(az, 1.0)) * az
    d = num / den
    d = jnp.where(jnp.isfinite(d), d, _ZERO)
    out_ref[...] = jnp.where(escf > 0.5, d, _NEG1)


_KERNELS = {
    "dwell": (_dwell_kernel, False),
    "green": (_green_kernel, True),
    "de": (_de_kernel, True),
    "tci": (_tci_kernel, True),
}


@functools.partial(
    jax.jit,
    static_argnames=("nx", "ny", "max_iter", "kind", "escape_r", "tile", "inner",
                     "interpret"),
)
def _field(params, nx, ny, max_iter, kind, escape_r, tile, inner, interpret):
    th, tw = tile
    kernel_fn, takes_r = _KERNELS[kind]
    kw = dict(max_iter=max_iter, inner=inner)
    if takes_r:
        kw["escape_r"] = escape_r
    return pl.pallas_call(
        functools.partial(kernel_fn, **kw),
        out_shape=jax.ShapeDtypeStruct((ny, nx), jnp.float32),
        grid=(ny // th, nx // tw),
        in_specs=[pl.BlockSpec((4,), lambda i, j: (0,))],
        out_specs=pl.BlockSpec((th, tw), lambda i, j: (i, j)),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name=f"escape_{kind}",
    )(params)


def _grid_params(domain, nx: int, ny: int):
    """f32 [xmin, ymin, dx, dy] of an np.linspace-style (ny, nx) grid."""
    xmin, xmax, ymin, ymax = domain
    return jnp.asarray([xmin, ymin, (xmax - xmin) / (nx - 1),
                        (ymax - ymin) / (ny - 1)], dtype=jnp.float32)


def mandelbrot_field_pallas(
    domain, nx: int, ny: int, max_iter: int = 500, kind: str = "dwell",
    escape_r: float = 4.0, tile: tuple = DEFAULT_TILE, inner: int = DEFAULT_INNER,
):
    """Field over an np.linspace-style grid (ny, nx), computed block-by-block.

    domain = (xmin, xmax, ymin, ymax); layout matches complex_grid()'s
    meshgrid(xs, ys, 'xy'). The grid is padded to block multiples at the
    same spacing and cropped back (the first ny rows / nx columns have the
    grid's own coordinates). "dwell" returns iteration counts as f32
    (max_iter where not escaped).
    """
    th, tw = _check_tile(tile)
    if kind not in _KERNELS:
        raise ValueError(f"unknown kind '{kind}'")
    interpret = pallas_interpret()
    with jax.enable_x64(False):
        params = _grid_params(domain, nx, ny)
        out = _field(params, _round_up(nx, tw), _round_up(ny, th), max_iter,
                     kind, escape_r, (th, tw), inner, interpret)
    return out[:ny, :nx]


def _bucket_shape(grid_n: int, tile: tuple):
    """Padded (ny, nx): the next power of two >= grid_n (and >= the block),
    so the tracker's growing grids share one compiled executable. A power
    of two at least as large as a power-of-two block is a block multiple."""
    th, tw = tile
    n = 1 << (grid_n - 1).bit_length()
    return max(th, n), max(tw, n)


def tci_de_field_pallas(domain, grid_n: int, max_iter: int = 250,
                        escape_r: float = 250.0, tile: tuple = DEFAULT_TILE,
                        inner: int = DEFAULT_INNER, bucket: bool = True):
    """(esc, d) of the TCI DE over a grid_n x grid_n np.linspace-style grid.

    The tracker's grid kernel (tci_construct_mandelbrot_v002_fixed.py:35-47)
    as a Pallas head: pads at the same spacing and crops. Returns (esc bool,
    d float32) device arrays.

    bucket=True pads to the next power of two, so the tracker's growing
    grids (600/690/793/912) share ONE compiled kernel across stages — the
    padding pixels are nearly free (far-field blocks exit after one chunk).
    """
    th, tw = _check_tile(tile)
    if bucket:
        ny, nx = _bucket_shape(grid_n, tile)
    else:
        ny, nx = _round_up(grid_n, th), _round_up(grid_n, tw)
    interpret = pallas_interpret()
    with jax.enable_x64(False):
        params = _grid_params(domain, grid_n, grid_n)
        out = _field(params, nx, ny, max_iter, "tci", escape_r, (th, tw), inner,
                     interpret)
    out = out[:grid_n, :grid_n]
    return out >= 0.0, jnp.maximum(out, 0.0)


def _tci_selection_core(params, grid_n, nx, ny, max_iter, escape_r, tile,
                        inner, interpret):
    """Device boundary-band selection on the PADDED bucket grid (traced).

    esc & (d <= q25(d[esc & in-grid])) with grid_n a traced scalar, so the
    tracker's growing grids share ONE compiled executable (the padded bucket
    shape is constant). Quantile = numpy's linear interpolation on sorted
    masked values.
    """
    out = _field(params, nx, ny, max_iter, "tci", escape_r, tile, inner, interpret)
    esc = out >= 0.0
    d = jnp.maximum(out, 0.0)
    valid = (jnp.arange(ny)[:, None] < grid_n) & (jnp.arange(nx)[None, :] < grid_n)
    escv = esc & valid
    df = d.reshape(-1)
    v = jnp.sort(jnp.where(escv.reshape(-1), df, jnp.inf))
    cnt = jnp.sum(escv)
    pos = 0.25 * (cnt - 1).astype(df.dtype)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, None)
    hi = jnp.clip(jnp.ceil(pos).astype(jnp.int32), 0, None)
    frac = pos - lo.astype(df.dtype)
    q = v[lo] * (1.0 - frac) + v[hi] * frac
    return escv & (d <= q), cnt, q


@functools.partial(jax.jit, static_argnames=("nx", "ny", "max_iter", "escape_r",
                                              "tile", "inner", "interpret"))
def _tci_selection_padded(params, grid_n, nx, ny, max_iter, escape_r, tile,
                          inner, interpret):
    """Selection-mask variant: a grid-sized bool mask is fetched."""
    return _tci_selection_core(params, grid_n, nx, ny, max_iter, escape_r,
                               tile, inner, interpret)


@functools.partial(jax.jit, static_argnames=("n_samples", "nx", "ny",
                                              "max_iter", "escape_r", "tile",
                                              "inner", "interpret"))
def _tci_sample_padded(params, grid_n, key, n_samples, nx, ny, max_iter,
                       escape_r, tile, inner, interpret):
    """Sample-fetch variant: Gumbel top-k over the band ON DEVICE, so only
    n_samples int32 indices (plus two scalars) reach the host instead of
    the grid-sized bool mask.

    Gumbel top-k over the band mask is a uniform subsample without
    replacement (the jit analogue of the reference's rng.choice,
    tci_construct_mandelbrot_v002_fixed.py:56-59). Returns ONE packed int32
    array [n_band, n_escaped, idx...] so the host needs a single fetch:
    idx indexes the flattened PADDED (ny, nx) grid; entries past n_band are
    garbage lanes of -inf score — callers truncate to min(n_samples,
    n_band), matching the reference's keep-all-when-small.
    """
    sel, cnt, _ = _tci_selection_core(params, grid_n, nx, ny, max_iter,
                                      escape_r, tile, inner, interpret)
    selv = sel.reshape(-1)
    g = jax.random.gumbel(key, selv.shape, dtype=jnp.float32)
    score = jnp.where(selv, g, -jnp.inf)
    _, idx = jax.lax.top_k(score, n_samples)
    head = jnp.stack([jnp.sum(selv).astype(jnp.int32), cnt.astype(jnp.int32)])
    return jnp.concatenate([head, idx.astype(jnp.int32)])


def tci_boundary_sample(domain, grid_n: int, n_samples: int, seed: int,
                        max_iter: int = 250, escape_r: float = 250.0,
                        tile: tuple = DEFAULT_TILE, inner: int = DEFAULT_INNER):
    """Host wrapper: boundary-band subsample with O(n_samples) host transfer.

    The quantile band AND the uniform without-replacement subsample run on
    device (_tci_sample_padded); the host fetches n_samples int32 indices
    and maps them to complex points on the reference's np.linspace grid.
    Raises like the host path when no pixel escapes. Returns complex (m,)
    with m = min(n_samples, band size).
    """
    th, tw = _check_tile(tile)
    ny, nx = _bucket_shape(grid_n, tile)
    interpret = pallas_interpret()
    with jax.enable_x64(False):
        params = _grid_params(domain, grid_n, grid_n)
        key = jax.random.key(seed)
        packed = _tci_sample_padded(
            params, jnp.int32(grid_n), key, n_samples, nx, ny, max_iter,
            escape_r, (th, tw), inner, interpret)
    from cmtci.utils.artifacts import fetch

    packed = fetch(packed)  # one fetch: [n_band, n_escaped, idx...]
    n_band, cnt = int(packed[0]), int(packed[1])
    if cnt == 0:
        raise RuntimeError("No escape points")
    take = min(n_samples, n_band)
    idx = packed[2 : 2 + take]
    xs = np.linspace(domain[0], domain[1], grid_n)
    ys = np.linspace(domain[2], domain[3], grid_n)
    return xs[idx % nx] + 1j * ys[idx // nx]


def tci_boundary_selection(domain, grid_n: int, max_iter: int = 250,
                           escape_r: float = 250.0, tile: tuple = DEFAULT_TILE,
                           inner: int = DEFAULT_INNER):
    """Host wrapper: (sel bool (grid_n, grid_n), n_escaped) for the TCI
    boundary sampler, computed fully on device.

    Reference semantics: escaped & d <= 25%-quantile of d over escaped
    pixels (tci_construct_mandelbrot_v002_fixed.py:49-55)."""
    th, tw = _check_tile(tile)
    ny, nx = _bucket_shape(grid_n, tile)
    interpret = pallas_interpret()
    with jax.enable_x64(False):
        params = _grid_params(domain, grid_n, grid_n)
        sel, cnt, _ = _tci_selection_padded(params, jnp.int32(grid_n), nx, ny,
                                            max_iter, escape_r, (th, tw), inner,
                                            interpret)
    from cmtci.utils.artifacts import fetch

    return fetch(sel)[:grid_n, :grid_n], int(cnt)


# ---------------------------------------------------------------------------
# f32 Green potential for point CLOUDS (the equipotential pipeline's hot
# kernel, lucas_equipotential_test_v3.py:124-162). Unlike the grid heads the
# coordinates are INPUT point blocks, the orbit state is resumable (host
# compaction staging drops escaped points between stages), and the outputs
# are the UNSCALED escape records (k, z_at_escape): the 2^-k scaling to
# g = log|z_k|*2^-k happens on host in f64, so deep escapers with
# k in (126, 1074] — whose g underflows f32 but not f64 — keep the exact
# f64-path magnitude semantics. What changes vs the f64 path is only the
# trajectory arithmetic (f32), a realization difference like the tracker's
# f32 DE head.
# ---------------------------------------------------------------------------


def _cloud_green_kernel(cr_ref, ci_ref, zr0_ref, zi0_ref,
                        k_ref, zer_ref, zei_ref, zr_ref, zi_ref, *,
                        iters: int, inner: int, escape_r: float):
    """One staging chunk of `iters` Green iterations on a point block.

    k output is RELATIVE to this stage's start, 1-based at first
    |z| > escape_r (0 = did not escape this stage); zer/zei latch z at that
    iteration. Analytically-interior points (c in cardioid/period-2 bulb —
    a property of c alone, valid for resumed states too) start inactive so
    interior-heavy blocks exit after one chunk; escaped lanes keep iterating
    to inf/nan harmlessly (act latches them out of the hit predicate).
    zr/zi return the resumable orbit state after `iters` iterations.
    """
    cr = cr_ref[...]
    ci = ci_ref[...]
    zero = jnp.zeros(cr.shape, jnp.float32)
    r2 = jnp.float32(escape_r * escape_r)

    def step(s, it):
        zr, zi, act, kk, zer, zei = s
        sv = it < iters
        nzr, nzi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        zr = jnp.where(sv, nzr, zr)
        zi = jnp.where(sv, nzi, zi)
        hit = (zr * zr + zi * zi > r2) & (act > 0.5) & sv  # inf -> True
        kk = jnp.where(hit, (it + 1).astype(jnp.float32), kk)
        zer = jnp.where(hit, zr, zer)
        zei = jnp.where(hit, zi, zei)
        return zr, zi, jnp.where(hit, _ZERO, act), kk, zer, zei

    state = (zr0_ref[...], zi0_ref[...],
             jnp.where(_interior_mask(cr, ci), _ZERO, _ONE), zero, zero, zero)
    zr, zi, _, kk, zer, zei = _chunked_loop(step, state, iters, inner,
                                            lambda s: jnp.max(s[2]) > 0.5)
    k_ref[...] = kk
    zer_ref[...] = zer
    zei_ref[...] = zei
    zr_ref[...] = zr
    zi_ref[...] = zi


@functools.partial(jax.jit, static_argnames=("iters", "escape_r", "block",
                                             "inner", "interpret"))
def _cloud_green(cr, ci, zr0, zi0, iters, escape_r, block, inner, interpret):
    (n,) = cr.shape
    spec = pl.BlockSpec((block,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_cloud_green_kernel, iters=iters, inner=inner,
                          escape_r=escape_r),
        out_shape=tuple(jax.ShapeDtypeStruct((n,), jnp.float32)
                        for _ in range(5)),
        grid=(n // block,),
        in_specs=[spec] * 4,
        out_specs=(spec,) * 5,
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="cloud_green",
    )(cr, ci, zr0, zi0)


@jax.jit
def _stack_outputs(arrs):
    """Pack same-shape f32 outputs for a single host fetch (bit-preserving)."""
    return jnp.stack(arrs)


def green_cloud_f32(points, max_iter: int = 20000, escape_r: float = 2.0,
                    stage_iters: int | None = None, block: int = CLOUD_BLOCK,
                    inner: int = DEFAULT_INNER):
    """(g, k, phi) of a complex cloud via the f32 Pallas head.

    Drop-in for kernels.mandelbrot.green_potential_compacted (identical
    output conventions: g = max(log|z_k| * 2^-k, 0) at first escape else 0,
    k = max_iter where never escaped, phi = exp(2^-k log z_k) else nan) with
    the trajectory run in f32 on the device. The g/phi magnitudes are
    computed on HOST in f64 from the unscaled (k, z_k) records, so the
    f32-underflow region k in (126, 1074] keeps its tiny-but-positive g
    exactly like the f64 path.

    stage_iters=None (default) runs the whole budget in ONE kernel launch:
    per-block early exit already stops escaped blocks, so host compaction
    between stages only adds round trips. Pass a smaller stage_iters to
    bound per-launch device time; escaped points are then compacted away
    between stages with O(survivors) host transfer (the staged resume
    replays the exact same f32 op sequence, so results are identical).
    """
    if block < 1 or block & (block - 1):
        raise ValueError(f"block {block} must be a power of two")
    stage_iters = max_iter if stage_iters is None else stage_iters
    from cmtci.utils.artifacts import fetch

    pts = np.asarray(points, dtype=complex).ravel()
    n = pts.size
    g = np.zeros(n)
    kk = np.full(n, max_iter, dtype=np.int32)
    phi = np.full(n, np.nan + 1j * np.nan, dtype=complex)
    # analytically-interior points can never escape: their final record
    # (g = 0, k = max_iter, phi = nan) is known up front, so drop them from
    # the staging loop entirely — without this, the per-n dominant roots
    # scattered through the cloud would pin their blocks to the full budget.
    # (exact f64 cardioid/bulb inequalities, NO margin — boundary points are
    # in M, and a point misclassified interior by f64 rounding sits within
    # ~1e-14 of the boundary, whose escape time ~1e7 iterations exceeds any
    # configured max_iter, so the iterated path would return the identical
    # non-escape record)
    xr, xi = pts.real, pts.imag
    q = (xr - 0.25) ** 2 + xi * xi
    interior = (q * (q + (xr - 0.25)) <= 0.25 * xi * xi) | (
        (xr + 1.0) ** 2 + xi * xi <= 0.0625)
    idx = np.arange(n)[~interior]
    cr_h = pts.real[~interior].astype(np.float32)
    ci_h = pts.imag[~interior].astype(np.float32)
    zr_h = np.zeros(len(idx), np.float32)
    zi_h = np.zeros(len(idx), np.float32)
    interpret = pallas_interpret()
    k0 = 0
    while k0 < max_iter and len(idx):
        iters = min(stage_iters, max_iter - k0)
        m = len(idx)
        # power-of-two block-count buckets share compiled executables as the
        # survivor set shrinks; c = 0 padding lanes are analytically interior
        npad = block << max(0, int(np.ceil(np.log2(max((m + block - 1) // block, 1)))))

        def _pad(a):
            return jnp.asarray(np.pad(a, (0, npad - m)))

        final = iters >= max_iter - k0
        with jax.enable_x64(False):
            out = _cloud_green(_pad(cr_h), _pad(ci_h), _pad(zr_h), _pad(zi_h),
                               iters, escape_r, block, inner, interpret)
            # ONE packed fetch per stage; the final stage doesn't need the
            # survivor state (out[3:5]) at all. All five outputs are f32;
            # stacking cannot change bits.
            packed = fetch(_stack_outputs(out[:3] if final else out))
        k_rel = packed[0][:m].astype(np.float64)
        esc = k_rel > 0
        if esc.any():
            zer = packed[1][:m][esc].astype(np.float64)
            zei = packed[2][:m][esc].astype(np.float64)
            k_abs = k0 + k_rel[esc]
            scale = np.exp2(-k_abs)  # f64: no underflow until k > 1074
            logr = 0.5 * np.log(np.maximum(zer * zer + zei * zei, 1e-300))
            gg = logr * scale
            hit_idx = idx[esc]
            g[hit_idx] = np.where(np.isfinite(gg) & (gg >= 0.0), gg, 0.0)
            kk[hit_idx] = k_abs.astype(np.int32)
            phi[hit_idx] = (np.exp(logr * scale)
                            * np.exp(1j * np.arctan2(zei, zer) * scale))
            keep = ~esc
            idx = idx[keep]
            cr_h, ci_h = cr_h[keep], ci_h[keep]
            if not final:
                zr_h = packed[3][:m][keep]
                zi_h = packed[4][:m][keep]
        elif not final:
            zr_h = packed[3][:m]
            zi_h = packed[4][:m]
        k0 += iters
    return g, kk, phi
