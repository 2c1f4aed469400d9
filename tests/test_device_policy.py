"""The accelerator policy (utils/device.py), the CLI's platform handling,
the compile-cache location and chip_smoke.py's refusal to run off the GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import cmtci
from cmtci import cli
from cmtci.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend, accel, interpret", [
    ("gpu", True, False),
    ("cpu", False, True),
])
def test_policy_predicates(monkeypatch, backend, accel, interpret):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.on_gpu() is accel
    assert device.pallas_interpret() is interpret


def test_heads_refuse_other_backends(monkeypatch):
    from cmtci.kernels.mandelbrot_pallas import (green_cloud_f32,
                                                 mandelbrot_field_pallas)

    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="not on the 'metal' backend"):
        mandelbrot_field_pallas((-2.1, 0.9, -1.5, 1.5), 64, 64, max_iter=10)
    with pytest.raises(RuntimeError, match="not on the 'metal' backend"):
        green_cloud_f32([0.5 + 0.5j], max_iter=10)


@pytest.mark.parametrize("backend, want", [
    ("gpu", ("float32", "pallas", "float32", "device")),
    ("cpu", ("float64", "jax", "float64", "scipy")),
])
def test_platform_defaults_follow_the_backend(monkeypatch, backend, want):
    import argparse

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    tr = argparse.Namespace(cmd="tracker", field_dtype=None, de_impl=None,
                            parity=False)
    cli._resolve_platform_defaults(tr)
    eq = argparse.Namespace(cmd="equipotential", green_dtype=None, parity=False)
    cli._resolve_platform_defaults(eq)
    em = argparse.Namespace(cmd="embeddings", eig_backend=None, eig_dtype=None,
                            knn_dtype=None, parity=False)
    cli._resolve_platform_defaults(em)
    assert (tr.field_dtype, tr.de_impl, eq.green_dtype, em.eig_backend) == want
    # and the FEM solver default follows the same predicate
    from cmtci.pipelines.uniformize_fem import FEMUniformizeConfig

    assert FEMUniformizeConfig().resolved_solver() == (
        "device" if backend == "gpu" else "spsolve")


def test_platform_gpu_fails_without_a_card():
    before = jax.config.jax_platforms
    try:
        with pytest.raises(SystemExit, match="no GPU backend"):
            cli.main(["--platform", "gpu", "doctor"])
    finally:
        jax.config.update("jax_platforms", before)
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("env", [None, "/some/where/cache"])
def test_compile_cache_dir(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cmtci._compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert cmtci._compile_cache_dir() == env


def test_import_sets_no_cache_when_the_environment_names_one(tmp_path):
    code = ("import jax, cmtci; c = jax.config; print(c.jax_compilation_cache_dir,"
            " c.jax_persistent_cache_min_compile_time_secs)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    cache_dir, min_secs = out.stdout.split()
    assert cache_dir == str(tmp_path)
    assert float(min_secs) > 0.0  # JAX's own default, not cmtci's 0.0


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_on_the_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
