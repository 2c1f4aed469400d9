"""cmtci — a JAX framework for the CM-TCI pipeline.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``aortizt/inverse-eigenvalue-loci-mandelbrot-correspondence``: inverse
eigenvalue clouds of generalized Lucas companion matrices, Mandelbrot
escape-time / distance-estimator / Green-function fields, boundary geometry,
spatial statistics, conformal uniformization, and the TCI/GI-flow
information-theoretic correspondence.

Design stance (see SURVEY.md §7): one installable library of pure functions
over arrays, everything jittable, fixed shapes + masks instead of boolean
indexing, complex numbers carried as (re, im) float64 pairs so the same code
runs on any JAX backend, host-CPU stages only for genuinely
data-dependent geometry (Delaunay), and CSV/JSON export only at the edges.
"""

import os as _os

from jax import config as _jax_config

# The analysis surfaces of the reference are float64 numpy; we match them.
# Perf-critical kernels opt into float32/bfloat16 explicitly.
_jax_config.update("jax_enable_x64", True)


def _compile_cache_dir() -> str:
    """Where the persistent XLA compile cache lives.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and is left
    alone. Otherwise the cache is a fixed `.jax_cache/` at the checkout root:
    the cache key includes the path, so a directory that moves never hits.
    """
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


# The tracker's stage shapes grow run-over-run but repeat across runs, and
# compiles dominate cold small-stage wall time. Where the environment names
# a cache, JAX reads it itself and nothing is set here.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax_config.update("jax_compilation_cache_dir", _compile_cache_dir())
    # persist even sub-second executables: the analysis pipelines compile
    # dozens of ~0.15 s kernels per process (e.g. the symmetry scan's 26),
    # which the default 1 s threshold silently recompiled on EVERY run
    _jax_config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

__version__ = "0.1.0"
