"""Complex arithmetic as (re, im) float pairs.

Every complex-valued kernel in cmtci carries complex numbers as a pair of
real arrays. This keeps one code path for CPU float64 parity tests and
device execution (not every backend has complex128), and it is also the
natural representation inside Pallas kernels.

All functions broadcast like the underlying jnp ops. A "pair" is any tuple
``(re, im)`` of equal-shape arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def of(z):
    """numpy/jnp complex array -> pair."""
    z = jnp.asarray(z)
    return jnp.real(z), jnp.imag(z)


def to_numpy(p):
    """pair -> host complex128 array."""
    re, im = p
    return np.asarray(re, dtype=np.float64) + 1j * np.asarray(im, dtype=np.float64)


def add(a, b):
    return a[0] + b[0], a[1] + b[1]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def mul(a, b):
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def scale(a, s):
    return a[0] * s, a[1] * s


def conj(a):
    return a[0], -a[1]


def abs2(a):
    return a[0] * a[0] + a[1] * a[1]


def absval(a):
    return jnp.sqrt(abs2(a))


def sq(a):
    """a*a with one fewer multiply."""
    ar, ai = a
    return ar * ar - ai * ai, 2.0 * ar * ai


def div(a, b):
    ar, ai = a
    br, bi = b
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def reciprocal(a):
    ar, ai = a
    d = ar * ar + ai * ai
    return ar / d, -ai / d


def log(a):
    """Principal branch complex log."""
    return 0.5 * jnp.log(abs2(a)), jnp.arctan2(a[1], a[0])


def exp(a):
    r = jnp.exp(a[0])
    return r * jnp.cos(a[1]), r * jnp.sin(a[1])


def expi(theta):
    return jnp.cos(theta), jnp.sin(theta)


def where(mask, a, b):
    return jnp.where(mask, a[0], b[0]), jnp.where(mask, a[1], b[1])


def full_like(a, fill):
    fill = complex(fill)
    return jnp.full_like(a[0], fill.real), jnp.full_like(a[1], fill.imag)
