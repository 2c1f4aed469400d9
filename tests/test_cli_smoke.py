"""CLI dispatch smoke tests (fast configs)."""

import json
import os

import numpy as np

from cmtci.cli import main


def test_boundary_curvature_stage1_report_chain(tmp_path):
    out = str(tmp_path)
    assert main(["boundary", "--res", "200", "--max-iter", "80", "--out", f"{out}/m"]) == 0
    assert main(["curvature", "--input-csv", f"{out}/m_boundary.csv",
                 "--neighbors", "5", "--out", f"{out}/c"]) == 0
    assert main(["stage1", "--max-n", "12", "--boundary-samples", "80",
                 "--out", f"{out}/bus"]) == 0
    for f in ("construct_points.csv", "mandel_boundary_sample.csv",
              "construct_aligned.csv", "matches_indices.csv"):
        assert os.path.exists(f"{out}/bus/{f}")
    assert main(["report", "--busdir", f"{out}/bus", "--out", f"{out}/rep"]) == 0
    assert os.path.exists(f"{out}/rep_phase5_summary.csv")


def test_tracker_cli(tmp_path):
    out = str(tmp_path / "trk")
    assert main(["tracker", "--sigma-bins", "2.0", "--t-fixed", "3",
                 "--bins-start", "16", "--bins-max", "16", "--out", out]) == 0
    import csv

    rows = list(csv.DictReader(open(out + ".csv")))
    assert len(rows) == 1 and rows[0]["bins"] == "16"
    meta = json.load(open(out + ".json"))
    assert meta["rows"][0]["T_n"] == 3


def test_doctor_cli(capsys):
    assert main(["doctor", "--smoke"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["default_backend"] == "cpu"  # conftest pins the CPU backend
    assert out["x64_enabled"] is True
    assert out["compile_cache"]["enabled"] in (True, False)
    smoke = out["smoke"]
    assert smoke["warm_s"] > 0 and smoke["checksum"] > 0
    assert not any(k.endswith("_error") for k in out)


def test_suite_cli(tmp_path, capsys):
    """`cmtci suite`: one process, per-stage artifacts identical to the
    standalone subcommands, one JSON summary line, loud unknown-stage error."""
    out = str(tmp_path)
    assert main(["stage1", "--max-n", "12", "--boundary-samples", "80",
                 "--out", f"{out}/bus"]) == 0
    capsys.readouterr()
    stages = "spectral,multifractal,embeddings,symmetry,spatial-stats,report"
    assert main(["suite", "--busdir", f"{out}/bus", "--stages", stages,
                 "--out", f"{out}/suite"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["stages"]) == set(stages.split(","))
    assert line["wall_s"] > 0 and "hausdorff" in line
    for f in ("spectral_bootstrap.csv", "multifractal_construct_multifractal.csv",
              "embeddings_eigenvalues_construct.csv",
              "symmetry_symmetry_report_bestaxis.csv",
              "spatial-stats_spatial_stats.csv", "report_phase5_summary.csv"):
        assert os.path.exists(f"{out}/suite/{f}"), f
    # value-identity with the standalone subcommand (same pipeline call)
    assert main(["report", "--busdir", f"{out}/bus", "--out", f"{out}/solo"]) == 0
    assert (open(f"{out}/suite/report_phase5_summary.csv").read()
            == open(f"{out}/solo_phase5_summary.csv").read())
    import pytest

    with pytest.raises(SystemExit, match="unknown stage"):
        main(["suite", "--busdir", f"{out}/bus", "--stages", "nope",
              "--out", f"{out}/x"])


def test_platform_aware_defaults(monkeypatch):
    """On a GPU session every dtype/backend knob defaults to its validated
    accel path; --parity (or an explicit value) opts out. VERDICT r4 item 6."""
    import argparse

    import cmtci.cli as cli

    # the conftest pins jax_platforms=cpu, so this process resolves host
    ns = argparse.Namespace(cmd="tracker", field_dtype=None, de_impl=None,
                            parity=False)
    cli._resolve_platform_defaults(ns)
    assert (ns.field_dtype, ns.de_impl) == ("float64", "jax")

    from cmtci.utils import device

    monkeypatch.setattr(device, "on_gpu", lambda: True)
    for parity, want in ((False, ("float32", "pallas")),
                         (True, ("float64", "jax"))):
        ns = argparse.Namespace(cmd="tracker", field_dtype=None, de_impl=None,
                                parity=parity)
        cli._resolve_platform_defaults(ns)
        assert (ns.field_dtype, ns.de_impl) == want, (parity, ns)
    # explicit value wins over the platform default
    ns = argparse.Namespace(cmd="tracker", field_dtype="float64", de_impl=None,
                            parity=False)
    cli._resolve_platform_defaults(ns)
    assert (ns.field_dtype, ns.de_impl) == ("float64", "pallas")
    # suite device + embeddings backend triples resolve too
    ns = argparse.Namespace(cmd="suite", device=None, parity=False)
    cli._resolve_platform_defaults(ns)
    assert ns.device == "accel"
    ns = argparse.Namespace(cmd="embeddings", eig_backend=None, eig_dtype=None,
                            knn_dtype=None, parity=False)
    cli._resolve_platform_defaults(ns)
    assert (ns.eig_backend, ns.eig_dtype, ns.knn_dtype) == (
        "device", "float32", "float32")
