"""Fourier boundary spectra, decay-exponent fits, bootstrap CIs, kernel spectra.

Reference behavior (reimplemented):
  * angle-order about centroid, complex FFT of centered signal, normalized
    magnitude, low-mode IFFT reconstructions — spatial_stats_phase4.py:8-78
  * amplitude decay-exponent fits over fixed log-frequency ranges
    (LinearRegression slope + R²) — spectral_decay_exponent.py:39-75
  * power-spectrum slope with 200-resample bootstrap 95% CI —
    phase4b_spectral_bootstrap.py:10-56
  * kernel-eigenvalue spectral distance (dense gaussian kernel, top-K
    eigenvalues, L2/sqrt(K)) — tci_construct_mandelbrot_v002_fixed.py:110-118

Device-first: bootstrap resampling is a single vmapped batch of closed-form
least-squares fits over jax.random index draws (vs a Python loop of sklearn
fits in the reference).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


from cmtci.utils.arrays import as_xy as _xy  # shared (N,2) coercion


def order_points_by_angle(points):
    """Sort by angle about the centroid (spatial_stats_phase4.py:9-13)."""
    xy = _xy(points)
    c = xy.mean(axis=0)
    ang = np.arctan2(xy[:, 1] - c[1], xy[:, 0] - c[0])
    return xy[np.argsort(ang)]


def boundary_fft(points, order: bool = True):
    """Centered complex-signal FFT. Returns (freqs, fft_coeffs)."""
    xy = order_points_by_angle(points) if order else _xy(points)
    z = xy[:, 0] + 1j * xy[:, 1]
    f = np.fft.fft(z - z.mean())
    return np.fft.fftfreq(len(f)), f


def amplitude_spectrum(points, order: bool = True):
    """Positive-frequency normalized |FFT| (spectral_decay_exponent.py:24-37)."""
    freqs, f = boundary_fft(points, order)
    m = freqs > 0
    amp = np.abs(f[m])
    return freqs[m], amp / amp.max()


def power_spectrum(points):
    """Positive-frequency normalized |FFT|² (phase4b_spectral_bootstrap.py:9-16).

    NOTE: phase4b does NOT angle-order its inputs (it FFTs file order).
    """
    xy = _xy(points)
    z = xy[:, 0] + 1j * xy[:, 1]
    spec = np.abs(np.fft.fft(z)) ** 2
    freqs = np.fft.fftfreq(len(z))
    m = freqs > 0
    return freqs[m], spec[m] / spec[m].max()


def reconstruct_low_modes(fft_coeffs, n_modes: int):
    """Low-mode IFFT reconstruction (spatial_stats_phase4.py:62-67).

    n_modes=1 keeps only the DC coefficient (the reference's slice
    coeffs[-0:] would silently copy everything).
    """
    coeffs = np.zeros_like(fft_coeffs, dtype=complex)
    coeffs[:n_modes] = fft_coeffs[:n_modes]
    if n_modes > 1:
        coeffs[-n_modes + 1 :] = fft_coeffs[-n_modes + 1 :]
    return np.fft.ifft(coeffs)


def _ols_slope_r2(x, y):
    """Plain least-squares slope/intercept/R² (== sklearn LinearRegression)."""
    xm, ym = x.mean(), y.mean()
    vx = ((x - xm) ** 2).sum()
    slope = (((x - xm) * (y - ym)).sum()) / vx
    intercept = ym - slope * xm
    resid = y - (slope * x + intercept)
    ss_res = (resid**2).sum()
    ss_tot = ((y - ym) ** 2).sum()
    return slope, intercept, 1.0 - ss_res / ss_tot


def fit_decay_exponent(freqs, spectrum, fmin: float, fmax: float):
    """Log-log slope + R² over [fmin, fmax] (spectral_decay_exponent.py:47-56).

    Returns (slope, r2, n_points) or None if fewer than 5 points in range.
    """
    m = (freqs >= fmin) & (freqs <= fmax)
    if m.sum() < 5:
        return None
    x = np.log10(freqs[m])
    y = np.log10(spectrum[m])
    slope, _, r2 = _ols_slope_r2(x, y)
    return float(slope), float(r2), int(m.sum())


@functools.partial(jax.jit, static_argnames=("n_bootstrap",))
def _bootstrap_slopes(x, y, key, n_bootstrap: int):
    n = x.shape[0]
    idx = jax.random.randint(key, (n_bootstrap, n), 0, n)

    def one(ii):
        xs, ys = x[ii], y[ii]
        xm, ym = xs.mean(), ys.mean()
        return ((xs - xm) * (ys - ym)).sum() / ((xs - xm) ** 2).sum()

    return jax.vmap(one)(idx)


def fit_slope_bootstrap(freqs, spectrum, fmin: float, fmax: float,
                        n_bootstrap: int = 200, seed: int = 0):
    """Slope, R², and bootstrap 95% CI (phase4b_spectral_bootstrap.py:18-37).

    The bootstrap is one vmapped batch on-device (the reference loops 200
    sklearn fits); resample draws use jax.random, so CI endpoints agree
    statistically (not bitwise) with the reference's sklearn.resample.
    """
    m = (freqs >= fmin) & (freqs <= fmax)
    if m.sum() < 2:  # empty/degenerate range: the reference fit_slope has
        # no guard and would crash in sklearn; return NaNs (tuple shape
        # kept for pipelines/spectral.py) instead of warning-laden NaNs.
        # >=2 points fit like the reference (only spectral_decay_exponent
        # uses a <5 skip; phase4b fits any non-empty range).
        nan = float("nan")
        return nan, nan, (nan, nan)

    x = np.log10(freqs[m])
    y = np.log10(spectrum[m])
    slope, _, r2 = _ols_slope_r2(x, y)
    slopes = np.asarray(_bootstrap_slopes(jnp.asarray(x), jnp.asarray(y),
                                          jax.random.PRNGKey(seed), int(n_bootstrap)))
    # a resample can draw all-identical x on very short ranges -> nan slope
    lo, hi = np.nanpercentile(slopes, [2.5, 97.5])
    return float(slope), float(r2), (float(lo), float(hi))


@functools.partial(jax.jit, static_argnames=("top_k",))
def _kernel_eigs(xy, sigma, top_k: int):
    d2 = jnp.sum((xy[:, None, :] - xy[None, :, :]) ** 2, axis=-1)
    k = jnp.exp(-d2 / (2.0 * sigma * sigma))
    w = jnp.linalg.eigvalsh(k)  # ascending; kernel is symmetric
    return w[-top_k:]


def spectral_distance(x, y, top_k: int = 30, sigma: float = 0.05) -> float:
    """Kernel-eigenvalue spectral distance (tci_..._v002_fixed.py:110-118).

    The reference uses nonsymmetric eigvals of a symmetric matrix then sorts
    real parts — identical spectrum; we use eigvalsh.
    """

    ax = jnp.asarray(_xy(x))
    by = jnp.asarray(_xy(y))
    w1 = _kernel_eigs(ax, sigma, top_k)
    w2 = _kernel_eigs(by, sigma, top_k)
    return float(jnp.linalg.norm(w1 - w2) / jnp.sqrt(top_k))
