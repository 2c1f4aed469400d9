"""2D histograms, mollification, and distribution distances (S9).

Reference behavior (reimplemented):
  * to_prob: histogram2d over a fixed domain, floor at eps, normalize —
    tci_construct_mandelbrot_v002_fixed.py:80-88
  * mollified_histogram: + scipy gaussian_filter(sigma_bins, mode="nearest"),
    re-floor, renormalize — gi_assumption_tracker_v3.py:109-125
  * KL with clip — tci_..._v002_fixed.py:86-88; TV = 0.5*sum|p-q|, overlap =
    sum min(p,q), fraction outside domain — gi_assumption_tracker_v3.py:93-106

histogram2d bin semantics match numpy exactly (edges = linspace(lo,hi,b+1),
values on interior edges go right, rightmost edge inclusive, out-of-range
values dropped); the scatter-add runs on-device via .at[].add.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np



@functools.partial(jax.jit, static_argnames=("bins",))
def histogram2d_edges(x, y, bins: int, xedges, yedges, xmax, ymax):
    """Scatter-add histogram against explicit edge arrays (numpy semantics:
    interior edges right-inclusive via searchsorted, rightmost edge inclusive,
    out-of-range dropped)."""
    ix = jnp.searchsorted(xedges, x, side="right") - 1
    iy = jnp.searchsorted(yedges, y, side="right") - 1
    ix = jnp.where(x == xmax, bins - 1, ix)
    iy = jnp.where(y == ymax, bins - 1, iy)
    ok = (ix >= 0) & (ix < bins) & (iy >= 0) & (iy < bins)
    flat = jnp.where(ok, ix * bins + iy, bins * bins)
    h = jnp.zeros(bins * bins + 1, dtype=x.dtype).at[flat].add(1.0)
    return h[:-1].reshape(bins, bins)


def np_edges(bins: int, domain):
    """np.histogram2d's exact bin edges (np.linspace; jnp.linspace differs in
    the last ulp, which flips points that sit exactly ON an edge — M points
    are DE-grid nodes and DO collide with edges: that 1-ulp edge difference
    was the tracker's whole stage-3 oracle residual)."""
    xmin, xmax, ymin, ymax = domain
    return np.linspace(xmin, xmax, bins + 1), np.linspace(ymin, ymax, bins + 1)


def histogram2d(x, y, bins: int, domain):
    """np.histogram2d(x, y, bins=(b,b), range=domain-pairs), bitwise.

    Host entry: edges come from np.linspace (reference semantics); the
    scatter-add runs on-device via .at[].add.
    """
    xedges, yedges = np_edges(bins, domain)
    return histogram2d_edges(jnp.asarray(x), jnp.asarray(y), bins,
                             jnp.asarray(xedges), jnp.asarray(yedges),
                             domain[1], domain[3])


def gaussian_kernel1d(sigma: float, truncate: float = 4.0):
    """scipy.ndimage gaussian kernel (order 0), bitwise-exact weights.

    Uses scipy's exact expression tree exp(-0.5/sigma**2 * x**2) — the
    algebraically-equal exp(-0.5*(x/sigma)**2) differs in the last ulp.
    """
    radius = int(truncate * float(sigma) + 0.5)
    sigma2 = float(sigma) * float(sigma)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 / sigma2 * x**2)
    return k / k.sum()


@functools.partial(jax.jit, static_argnames=("radius",))
def _sep_correlate_nearest(h, kernel, radius: int):
    """Separable correlation with 'nearest' edges, scipy's summation order.

    scipy.ndimage's correlate1d exploits kernel symmetry: per output element
    it computes  w[mid]*x[i] + sum_{k=r..1} w[mid+k]*(x[i-k] + x[i+k])  with
    k descending (outermost pair first). Reproducing that exact expression tree makes the filter
    bitwise-equal to scipy — which is what closes the tracker's stage-3
    parity residual (the old linear-sweep order differed by ~3e-15/bin,
    amplified to ~1e-6 in the stage metrics through the eps floor + log).
    The taps run as a loop, not unrolled: the coupling pipeline's radii
    reach ~180, and an unrolled graph that size took minutes to compile
    for the GPU.
    """
    def corr1(a):  # along axis 0
        ap = jnp.concatenate(
            [jnp.repeat(a[:1], radius, axis=0), a, jnp.repeat(a[-1:], radius, axis=0)], axis=0
        )
        n = a.shape[0]

        def tap(i, out):  # k = radius - i: scipy iterates pairs outermost-first
            left = jax.lax.dynamic_slice_in_dim(ap, i, n, axis=0)
            right = jax.lax.dynamic_slice_in_dim(ap, 2 * radius - i, n, axis=0)
            return out + kernel[2 * radius - i] * (left + right)

        return jax.lax.fori_loop(0, radius, tap, kernel[radius] * a)

    h = corr1(h)
    h = corr1(h.T).T
    return h


def _corr1_np(a, kernel, radius: int):
    """One numpy correlation pass along axis 0, scipy's expression tree."""
    ap = np.concatenate(
        [np.repeat(a[:1], radius, axis=0), a, np.repeat(a[-1:], radius, axis=0)], axis=0
    )
    n = a.shape[0]
    out = kernel[radius] * a
    for k in range(radius, 0, -1):  # scipy iterates pairs outermost-first
        out += kernel[radius + k] * (ap[radius - k : radius - k + n]
                                     + ap[radius + k : radius + k + n])
    return out


def gaussian_filter_nearest(h, sigma: float, truncate: float = 4.0):
    """scipy.ndimage.gaussian_filter(h, sigma, mode='nearest'), bitwise.

    scipy correlates with the REVERSED kernel; a symmetric gaussian makes
    correlation == convolution, and the symmetric-pair summation order
    (w[mid]*x + sum_k w[mid+k]*(x[-k]+x[+k]), k descending) matches scipy's
    C kernel exactly — numpy evaluates that expression tree with no FMA
    contraction, so concrete inputs reproduce scipy to the last bit (which
    closes the tracker's stage-3 oracle residual). Traced (jit/shard_map)
    inputs take the jnp path, identical up to XLA FMA (~4e-16).
    """
    kernel_np = gaussian_kernel1d(sigma, truncate)
    radius = (len(kernel_np) - 1) // 2
    if isinstance(h, jax.core.Tracer):
        # kernel in h's dtype: an f32 traced step stays f32-only on device
        # (concrete/f64 callers are unaffected — kernel_np is f64 already)
        return _sep_correlate_nearest(h, jnp.asarray(kernel_np, dtype=h.dtype),
                                      radius)
    a = np.asarray(h, dtype=float)
    return _corr1_np(_corr1_np(a, kernel_np, radius).T, kernel_np, radius).T


def to_prob(cloud, bins: int, domain, eps: float = 1e-12):
    """Probability histogram of a complex cloud (tci_..._v002_fixed.py:80-84)."""
    cloud = np.asarray(cloud)
    h = histogram2d(jnp.asarray(cloud.real), jnp.asarray(cloud.imag), bins, domain)
    h = jnp.maximum(h, eps)
    return h / h.sum()


def _histogram2d_np(x, y, bins: int, domain):
    """Pure-numpy histogram2d with the exact jnp-path semantics.

    searchsorted on identical f64 inputs returns identical indices and the
    counts are small-integer sums, so the counts are bitwise-equal to the
    histogram2d jit (downstream normalization differs only in reduction
    order, ~1e-19/bin) — and it never touches the host XLA stream, which
    the tracker's background eigensweeps keep busy (a host-jit histogram
    there waits ~0.1 s/stage behind a 0.19 s Aberth execution)."""
    xmin, xmax, ymin, ymax = domain
    xedges, yedges = np_edges(bins, domain)
    ix = np.searchsorted(xedges, x, side="right") - 1
    iy = np.searchsorted(yedges, y, side="right") - 1
    ix = np.where(x == xmax, bins - 1, ix)
    iy = np.where(y == ymax, bins - 1, iy)
    ok = (ix >= 0) & (ix < bins) & (iy >= 0) & (iy < bins)
    flat = ix[ok] * bins + iy[ok]
    return np.bincount(flat, minlength=bins * bins).astype(float).reshape(bins, bins)


def mollified_histogram(cloud, bins: int, domain, sigma_bins: float, eps: float = 1e-12,
                        mesh=None, host_numpy: bool = False):
    """gi_assumption_tracker_v3.py:109-125 semantics.

    With a `mesh`, the scatter-add is point-sharded over the devices and
    psum-reduced (bitwise-identical: per-bin counts are small integers, so
    f64 addition is exact in any order); the mollifier runs replicated.
    host_numpy=True computes everything in numpy/scipy-order host code (no
    XLA stream) — the tracker fast path's choice while background
    eigensweeps occupy the host CPU stream.
    """
    cloud = np.asarray(cloud)
    if host_numpy and mesh is None:
        from scipy.ndimage import gaussian_filter as _scipy_gauss

        h = _histogram2d_np(cloud.real.ravel(), cloud.imag.ravel(), bins, domain)
        h = np.maximum(h, eps)
        if sigma_bins and sigma_bins > 0:
            # the reference's own scipy call (gi_assumption_tracker_v3.py:
            # 109-125); gaussian_filter_nearest reproduces it bitwise, so
            # using scipy here keeps identical values at C speed
            h = _scipy_gauss(h, float(sigma_bins), mode="nearest")
            h = np.maximum(h, eps)
        return h / h.sum()
    if mesh is not None:
        from cmtci.parallel.sharded import sharded_histogram

        n_dev = mesh.devices.size
        n = cloud.size
        npad = ((n + n_dev - 1) // n_dev) * n_dev
        xr = np.pad(cloud.real.ravel(), (0, npad - n), constant_values=domain[1] + 1.0)
        xi = np.pad(cloud.imag.ravel(), (0, npad - n), constant_values=domain[3] + 1.0)
        h = sharded_histogram(jnp.asarray(xr), jnp.asarray(xi), bins, domain, mesh)
    else:
        h = histogram2d(jnp.asarray(cloud.real), jnp.asarray(cloud.imag), bins, domain)
    from cmtci.utils.artifacts import fetch

    h = jnp.asarray(fetch(h))
    h = jnp.maximum(h, eps)
    if sigma_bins and sigma_bins > 0:
        h = gaussian_filter_nearest(h, float(sigma_bins))
        h = jnp.maximum(h, eps)
    return h / h.sum()


def kl(p, x, eps: float = 1e-12):
    """KL(P||X) with clipping (tci_..._v002_fixed.py:86-88).

    Pure numpy on the host: these are O(bins²) scalar reductions called
    between device stages — an XLA-CPU dispatch here queues behind whatever
    the host stream is running (e.g. the tracker's background eigensweeps).
    Jitted flows use giflow._kl_jit instead."""
    p = np.clip(np.asarray(p), eps, None)
    x = np.clip(np.asarray(x), eps, None)
    return float(np.sum(p * (np.log(p) - np.log(x))))


def tv_distance(p, q) -> float:
    return 0.5 * float(np.sum(np.abs(np.asarray(p) - np.asarray(q))))


def overlap_mass(p, q) -> float:
    return float(np.sum(np.minimum(np.asarray(p), np.asarray(q))))


def pinsker_bound(delta: float) -> float:
    return math.sqrt(0.5 * float(delta))


def fraction_outside_domain(cloud, domain) -> float:
    xmin, xmax, ymin, ymax = domain
    cloud = np.asarray(cloud)
    x, y = cloud.real, cloud.imag
    inside = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    return float(1.0 - np.mean(inside))
