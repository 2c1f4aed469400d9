"""Accelerator policy: one predicate that every platform decision reads.

The accelerator is the GPU. A session whose default backend is the GPU gets
the accelerator defaults (cli._PLATFORM_FLAGS: f32 device kernels and the
Pallas heads); every other session runs the host/f64 defaults. f64 math
runs on whatever the default device is — the GPU has f64 in hardware.
"""

from __future__ import annotations

import contextlib
import functools

import jax


def on_gpu() -> bool:
    """Whether the session's default backend is the GPU."""
    return jax.default_backend() == "gpu"


def pallas_interpret() -> bool:
    """interpret= for the Pallas heads: the interpreter on the CPU backend
    (where the tests run them), compiled through Triton on the GPU, and an
    error anywhere else — a head never runs interpreted on an accelerator."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"the Pallas escape-time heads run on 'gpu' (Triton) or 'cpu' "
        f"(interpreter), not on the {backend!r} backend")


def analysis_dtype_ctx(dtype=None):
    """(dtype, x64 ctx) for a dual-precision analysis stage.

    The one policy every device-backend stats stage shares (embeddings
    Lanczos, multifractal count grid, pair scans, symmetry NN): dtype=None
    is the ambient precision (f64 when x64 is on); an explicit f32 dtype
    traces with x64 disabled so no 64-bit scalar leaks into the f32 heads.
    """
    import jax.numpy as jnp

    dt = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    if dt == jnp.float64:
        return dt, contextlib.nullcontext()
    return dt, jax.enable_x64(False)


def highest_precision(fn):
    """Trace fn's matrix products at HIGHEST precision: on the GPU an f32
    product otherwise runs in TF32 (~3 decimal digits), far outside the
    ~1e-6 contracts of the f32 device paths."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


def gpu_card() -> str:
    """The GPU's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (one line per card). Every measured time is reported beside it: a
    card set below its maximum power runs slower under load."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
