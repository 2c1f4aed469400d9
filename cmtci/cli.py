"""cmtci command-line driver — one CLI replacing the reference's 33 scripts.

Subcommands mirror the reference catalog (SURVEY.md §2.5, README.md:208-299
there): boundary, lucas-boundary, construct-boundary, curvature, stage1,
tracker, tci, equipotential, variograms, spectral, multifractal,
embeddings, symmetry, spatial-stats, report, coupling, uniformize-fem,
uniformize-green, bench.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


#: the seven per-script bus analyses (SURVEY §2.5) `cmtci suite` chains
_SUITE_STAGES = ("spectral", "multifractal", "embeddings", "symmetry",
                 "spatial-stats", "report", "coupling")


def _add_common(p):
    p.add_argument("--out", default="outputs/run", help="output prefix/dir")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the pipeline's data-parallel stages over the "
                        "first N jax devices (jax.sharding.Mesh; 1 = single-"
                        "device, the default)")
    if not any(a.option_strings == ["--parity"] for a in p._actions):
        p.add_argument("--parity", action="store_true",
                       help="force the host/f64 reference-parity defaults "
                            "for every dtype/backend knob (on a GPU session "
                            "the validated accel paths are the default; "
                            "explicit per-flag values always win)")


#: per-subcommand (flag, accel default, host default) triples resolved by
#: _resolve_platform_defaults: on a GPU session every dtype/backend knob
#: defaults to its validated accel path (SURVEY §7 design stance); --parity
#: or an explicit per-flag value opts out.
_PLATFORM_FLAGS = {
    "tracker": (("field_dtype", "float32", "float64"),
                ("de_impl", "pallas", "jax")),
    "tci": (("de_impl", "pallas", "jax"),),
    "equipotential": (("green_dtype", "float32", "float64"),),
    "variograms": (("vario_dtype", "float32", "float64"),
                   ("field_dtype", "float32", "float64")),
    "symmetry": (("scan_dtype", "float32", "float64"),),
    "spatial-stats": (("stat_dtype", "float32", "float64"),),
    "multifractal": (("box_backend", "device", "host"),
                     ("box_dtype", "float32", "float64")),
    "embeddings": (("eig_backend", "device", "scipy"),
                   ("eig_dtype", "float32", "float64"),
                   ("knn_dtype", "float32", "float64")),
    "coupling": (("coupling_field_dtype", "float32", "float64"),
                 ("coupling_vario_dtype", "float32", "float64")),
    "uniformize-green": (("map_dtype", "float32", "float64"),),
    "suite": (("device", "accel", "host"),),
}


def _resolve_platform_defaults(args) -> None:
    """Fill every None dtype/backend flag with its platform default.

    Reads the device policy (utils.device.on_gpu), so it runs after
    --platform is applied: a CPU session — `--platform cpu` included —
    gets the host defaults (interpreted Pallas on the CPU is an effective
    hang, and f32 numerics would silently replace f64).
    """
    from cmtci.utils.device import on_gpu

    accel_session = on_gpu() and not getattr(args, "parity", False)
    for name, accel, host in _PLATFORM_FLAGS.get(args.cmd, ()):
        if getattr(args, name, None) is None:
            setattr(args, name, accel if accel_session else host)


#: subcommands whose dispatch actually threads a --devices mesh through
_MESH_COMMANDS = ("boundary", "tracker", "equipotential", "variograms",
                  "spatial-stats", "coupling", "suite")


def _mesh_from_args(args):
    n = getattr(args, "devices", 1) or 1
    if n <= 1:
        return None
    import jax

    from cmtci.parallel.sharded import device_mesh

    devs = jax.devices()
    if len(devs) < n:
        # never silently shrink the mesh — the user would believe the run
        # was N-way when it was len(devs)-way
        raise SystemExit(
            f"--devices {n} needs {n} devices but only {len(devs)} are "
            f"available on '{devs[0].platform}'. For virtual CPU devices "
            "set XLA_FLAGS=--xla_force_host_platform_device_count=N.")
    return device_mesh(n)


def _add_cache_trace(p):
    p.add_argument("--cache-dir", default=None,
                   help="stage artifact cache dir (resume; keyed by config hash)")
    p.add_argument("--trace-dir", default=None,
                   help="jax.profiler trace dir (per-stage traces + wall times)")


def _timer(args):
    from cmtci.utils.artifacts import StageTimer

    return StageTimer(trace_dir=getattr(args, "trace_dir", None))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cmtci", description=__doc__)
    ap.add_argument("--platform", choices=["auto", "cpu", "gpu"], default="auto",
                    help="force a jax backend (auto = JAX's own choice; gpu "
                         "fails when no GPU is present)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("boundary", help="Mandelbrot dwell grid + isocontour boundary")
    p.add_argument("--xlim", nargs=2, type=float, default=[-2.1, 0.9])
    p.add_argument("--ylim", nargs=2, type=float, default=[-1.5, 1.5])
    p.add_argument("--res", type=int, default=2000)
    p.add_argument("--max-iter", type=int, default=500)
    p.add_argument("--level", type=float, default=0.96)
    _add_common(p)

    p = sub.add_parser("lucas-boundary", help="Lucas cloud -> alpha-shape boundary npy")
    p.add_argument("--n-min", type=int, default=2)
    p.add_argument("--n-max", type=int, default=100)
    p.add_argument("--alpha", type=float, default=4.5)
    p.add_argument("--n-boundary", type=int, default=2000)
    _add_common(p)
    _add_cache_trace(p)

    p = sub.add_parser("construct-boundary", help="alpha-shape boundary of a point CSV")
    p.add_argument("--input-csv", required=True)
    p.add_argument("--alpha", type=float, default=65.0)
    p.add_argument("--target-n", type=int, default=1500)
    _add_common(p)

    p = sub.add_parser("curvature", help="local-polynomial curvature of a boundary CSV")
    p.add_argument("--input-csv", required=True)
    p.add_argument("--neighbors", type=int, default=7)
    p.add_argument("--closed", type=lambda s: s.lower() in ("1", "true", "yes"), default=True)
    _add_common(p)

    p = sub.add_parser("stage1", help="stage-1 cleaning pipeline (file bus)")
    p.add_argument("--max-n", type=int, default=40)
    p.add_argument("--boundary-samples", type=int, default=600)
    _add_common(p)

    p = sub.add_parser("tracker", help="GI assumption tracker (Appendix A)")
    p.add_argument("--sigma-bins", type=float, default=1.0)
    p.add_argument("--t-fixed", type=int, default=-1)
    p.add_argument("--bins-start", type=int, default=64)
    p.add_argument("--bins-max", type=int, default=1024)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--domain", type=str, default="-2.2:1.2:-1.6:1.6")
    p.add_argument("--parity", action="store_true", help="bitwise oracle-parity mode")
    p.add_argument("--field-dtype", choices=["float64", "float32"], default=None,
                   help="float32 = the GPU fast path (DE grid + matcher on "
                        "device; the GPU-session default — --parity or an "
                        "explicit float64 opts out)")
    p.add_argument("--de-impl", choices=["jax", "pallas"], default=None,
                   help="pallas = fused early-exit GPU DE head (GPU-session "
                        "default)")
    _add_common(p)
    _add_cache_trace(p)

    p = sub.add_parser("tci", help="TCI flow pipeline (v002_fixed main)")
    p.add_argument("--grid", type=int, default=600,
                   help="DE grid resolution (BASELINE configs[4]: 2400 = 4x)")
    p.add_argument("--samples", type=int, default=25000)
    p.add_argument("--t-steps", type=int, default=60)
    p.add_argument("--de-impl", choices=["jax", "numpy", "pallas"], default=None,
                   help="pallas = f32 GPU DE head + device quantile band + "
                        "Gumbel top-k subsample (O(n_samples) host transfer)")
    _add_common(p)

    p = sub.add_parser("equipotential", help="Green-function statistics + family comparison")
    p.add_argument("--n-min", type=int, default=2)
    p.add_argument("--n-max", type=int, default=200)
    p.add_argument("--max-iter", type=int, default=20000)
    p.add_argument("--skip-per-n", action="store_true")
    p.add_argument("--green-dtype", choices=["float64", "float32"],
                   default=None,
                   help="float32 = cloud Green potential on the GPU "
                        "(Pallas head; identical escape set, g ~1e-7 rel)")
    p.add_argument("--curve-npy", default=None,
                   help="stored boundary curve (.npy) to analyze too: its "
                        "Green potential is summarized, law-compared, and "
                        "saved as g_curve.npy (reference section C)")
    _add_common(p)
    _add_cache_trace(p)

    p = sub.add_parser("variograms", help="potentials + semivariograms + cross")
    p.add_argument("--grid", type=int, default=256)
    p.add_argument("--detrend", action="store_true")
    p.add_argument("--fit-model", action="store_true")
    p.add_argument("--vario-dtype", choices=["float64", "float32"], default=None,
                   help="float32 = all-pairs binning on the GPU (~4e-6 rel)")
    p.add_argument("--field-dtype", choices=["float64", "float32"], default=None,
                   help="float32 = DE proxy + potentials on the GPU "
                        "(borderline DE-threshold points flip)")
    _add_common(p)

    for name in _SUITE_STAGES:
        p = sub.add_parser(name, help=f"{name} analysis over the stage-1 file bus")
        p.add_argument("--busdir", default="out_clean", help="stage-1 file-bus directory")
        if name == "symmetry":
            p.add_argument("--scan-dtype", choices=["float64", "float32"],
                           default=None,
                           help="float32 = 361-angle best-axis scan on the GPU")
        if name == "spatial-stats":
            p.add_argument("--stat-dtype", choices=["float64", "float32"],
                           default=None,
                           help="float32 = the three O(n²) pair scans "
                                "(g(r)/Ripley shell counts + Hausdorff) on "
                                "the GPU (exact int32 counts; borderline "
                                "f32 bin flips possible)")
        if name == "multifractal":
            p.add_argument("--box-backend", choices=["host", "device"],
                           default=None,
                           help="device = box counts/partition sums on the "
                                "default jax device (fixed-shape count grid)")
            p.add_argument("--box-dtype", choices=["float64", "float32"],
                           default=None,
                           help="float32 = device count grid on the GPU")
        if name == "embeddings":
            p.add_argument("--eig-backend", choices=["scipy", "device"],
                           default=None,
                           help="device = dense-Lanczos eigensolver on the "
                                "default jax device (scipy = eigsh oracle)")
            p.add_argument("--eig-dtype", choices=["float64", "float32"],
                           default=None,
                           help="float32 = Lanczos on the GPU (agreement "
                                "~1e-6)")
            p.add_argument("--knn-dtype", choices=["float64", "float32"],
                           default=None,
                           help="float32 = the blocked kNN on the GPU too "
                                "(the wall at 5k+ points; f32 can reorder "
                                "tied neighbors)")
        if name == "coupling":
            p.add_argument("--field-dtype", dest="coupling_field_dtype",
                           choices=["float64", "float32"], default=None,
                           help="float32 = both potential grids on the GPU "
                                "(nudge trajectory bitwise-unchanged; "
                                "corr diagnostics to ~1e-3)")
            p.add_argument("--vario-dtype", dest="coupling_vario_dtype",
                           choices=["float64", "float32"], default=None,
                           help="float32 = the O(n²) point variogram on the "
                                "GPU too (an f32 trajectory REALIZATION — "
                                "a_est feeds the nudge; int32 counts have "
                                "no rounding but borderline pairs can land "
                                "one bin over vs f64; the opt-in for 5k+ "
                                "point clouds)")
        _add_common(p)

    p = sub.add_parser("suite", help="ALL bus analyses in one process (shared "
                                     "startup + warm jit caches; per-stage "
                                     "artifacts and times)")
    p.add_argument("--busdir", default="out_clean", help="stage-1 file-bus directory")
    p.add_argument("--stages", default="all",
                   help="comma list from {" + ",".join(_SUITE_STAGES) + "} "
                        "(default: all seven, in catalog order)")
    p.add_argument("--device", choices=["host", "accel"], default=None,
                   help="accel = every stage's opt-in f32/device path "
                        "(multifractal/embeddings/symmetry/spatial-stats/"
                        "coupling on the GPU; spectral/report are f64-host "
                        "by design); host = the exact per-command f64 defaults")
    p.add_argument("--trace-dir", default=None,
                   help="jax.profiler trace dir (per-stage traces + wall times)")
    _add_common(p)

    p = sub.add_parser("uniformize-fem", help="v18 FEM quasiconformal pipeline")
    p.add_argument("--levels", type=int, default=4, choices=[1, 2, 3, 4],
                   help="number of refinement levels (the reference v18 runs "
                        "all 4, L0-L3; the full study is ~1 s warm)")
    p.add_argument("--solver", choices=["auto", "spsolve", "cg", "device"],
                   default="auto",
                   help="FEM linear solver: device = the fused on-device "
                        "θ-iteration (one dispatch per mesh, dense Cholesky; "
                        "f32 on GPU with a final host f64 solve); auto picks "
                        "device on a GPU session, SuperLU otherwise")
    _add_common(p)

    p = sub.add_parser("uniformize-green", help="v40 boundary-integral Riemann map")
    p.add_argument("--lucas-npy", default=None, help="lucas_points.npy (else generated)")
    p.add_argument("--n-bdy", type=int, default=2000)
    p.add_argument("--interior-n", type=int, default=20000)
    p.add_argument("--map-dtype", choices=["float64", "float32"],
                   default=None,
                   help="float32 = GPU fast path for the map evaluations "
                        "(fit stays f64 on host; see GreenUniformizeConfig)")
    _add_common(p)
    _add_cache_trace(p)

    p = sub.add_parser("doctor", help="environment / backend diagnostics "
                                      "(backend, devices, x64, compile cache, "
                                      "device policy; --smoke times a kernel)")
    p.add_argument("--smoke", action="store_true",
                   help="run and time a small dwell kernel on the default "
                        "backend (first call pays the compile)")

    args = ap.parse_args(argv)
    if getattr(args, "devices", 1) > 1 and args.cmd not in _MESH_COMMANDS:
        # reject rather than silently no-op a requested mesh
        raise SystemExit(
            f"--devices: `cmtci {args.cmd}` has no mesh-sharded stage; "
            f"supported subcommands: {', '.join(_MESH_COMMANDS)}")
    _apply_platform(args.platform)
    _resolve_platform_defaults(args)
    return _dispatch(args)


def _apply_platform(platform: str) -> None:
    """--platform: `auto` leaves JAX's own choice alone; `cpu` pins the host;
    `gpu` pins CUDA and fails rather than fall back when there is no GPU."""
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif platform == "gpu":
        jax.config.update("jax_platforms", "cuda")
        try:
            backend = jax.default_backend()
        except (RuntimeError, AssertionError) as e:  # no CUDA plugin/device
            backend = repr(e)[:200]
        if backend != "gpu":
            raise SystemExit(f"--platform gpu: no GPU backend ({backend})")


def _doctor(smoke: bool = False) -> dict:
    """Environment diagnostics: what will run where, and is it healthy.

    Every field degrades to an "<field>_error" string rather than failing
    the whole report."""
    import os
    import time

    import jax

    import cmtci

    out = {"cmtci": cmtci.__version__, "jax": jax.__version__,
           "numpy": np.__version__}

    def field(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — a doctor must not die mid-exam
            out[name + "_error"] = repr(e)[:200]

    from cmtci.utils import device as dev

    field("default_backend", jax.default_backend)
    field("devices", lambda: [str(d) for d in jax.devices()])
    field("x64_enabled", lambda: bool(jax.config.jax_enable_x64))
    field("accelerator_defaults", dev.on_gpu)

    def cache():
        d = jax.config.jax_compilation_cache_dir
        info = {"dir": d, "enabled": bool(d)}
        if d and os.path.isdir(d):
            entries = os.listdir(d)
            info["entries"] = len(entries)
            total = 0
            for f in entries:
                try:  # concurrent JAX processes rename/evict entries
                    total += os.path.getsize(os.path.join(d, f))
                except OSError:
                    pass
            info["bytes"] = total
        return info
    field("compile_cache", cache)

    if smoke:
        def run_smoke():
            import jax.numpy as jnp
            n = 512
            with jax.enable_x64(False):
                if dev.on_gpu():
                    from cmtci.kernels.mandelbrot_pallas import (
                        mandelbrot_field_pallas)

                    def f(p):
                        return jnp.sum(mandelbrot_field_pallas(
                            (-2.1 + p, 0.9 + p, -1.5, 1.5), n, n, 200))
                    p = 0.0
                else:
                    from cmtci.parallel.sharded import _dwell_local

                    xs = jnp.linspace(-2.1, 0.9, n, dtype=jnp.float32)
                    ys = jnp.linspace(-1.5, 1.5, n, dtype=jnp.float32)
                    f = jax.jit(lambda p: jnp.sum(_dwell_local(
                        jnp.broadcast_to(xs[None, :] + p, (n, n)),
                        jnp.broadcast_to(ys[:, None], (n, n)), 200)))
                    p = jnp.float32(0.0)
                t0 = time.time()
                s0 = float(f(p))
                compile_and_run_s = time.time() - t0
                t0 = time.time()
                float(f(p + 1e-9))  # host fetch forces execution
                warm_s = time.time() - t0
            return {"grid": f"{n}x{n} dwell, max_iter=200",
                    "checksum": s0,
                    "compile_and_run_s": round(compile_and_run_s, 3),
                    "warm_s": round(warm_s, 4)}
        field("smoke", run_smoke)
    return out


#: per-stage opt-in f32/device knobs selected by `suite --device accel`
#: (the same strings the standalone subcommands' flags accept)
_ACCEL_STAGE_OPTS = {
    "multifractal": {"box_backend": "device", "box_dtype": "float32"},
    "embeddings": {"eig_backend": "device", "eig_dtype": "float32",
                   "knn_dtype": "float32"},
    "symmetry": {"scan_dtype": "float32"},
    "spatial-stats": {"stat_dtype": "float32"},
    "coupling": {"field_dtype": "float32", "vario_dtype": "float32"},
}


def _bus_stage_opts_from_args(st, args) -> dict:
    """The standalone subcommand's flags as a stage-opts dict."""
    if st == "multifractal":
        return {"box_backend": args.box_backend, "box_dtype": args.box_dtype}
    if st == "embeddings":
        return {"eig_backend": args.eig_backend, "eig_dtype": args.eig_dtype,
                "knn_dtype": args.knn_dtype}
    if st == "symmetry":
        return {"scan_dtype": args.scan_dtype}
    if st == "spatial-stats":
        return {"stat_dtype": args.stat_dtype}
    if st == "coupling":
        return {"field_dtype": args.coupling_field_dtype,
                "vario_dtype": args.coupling_vario_dtype}
    return {}


def _run_bus_stage(st, c, m, ca, matches, out_prefix, opts, mesh=None) -> dict:
    """One bus analysis stage — the SINGLE dispatch the standalone
    subcommands and `cmtci suite` share (same pipeline call, same artifact
    layout, so suite outputs are value-identical per stage). `opts` holds
    the stage's knobs in CLI-string form ("float32"/"device"/...); returns
    the summary values the CLI prints."""
    import jax.numpy as jnp

    from cmtci.pipelines import analysis

    def f32(key):
        return jnp.float32 if opts.get(key) == "float32" else None

    if st == "spectral":
        from cmtci.pipelines.spectral import SpectralConfig, run_spectral

        o = run_spectral(c, m, SpectralConfig(), out_prefix)
        return {"power_slopes_bootstrap": o["power_slopes_bootstrap"]}
    if st == "multifractal":
        analysis.run_multifractal(c, m, out_prefix=out_prefix,
                                  box_backend=opts.get("box_backend", "host"),
                                  box_dtype=f32("box_dtype"))
        return {}
    if st == "embeddings":
        o = analysis.run_embeddings(c, m, out_prefix=out_prefix,
                                    eig_backend=opts.get("eig_backend", "scipy"),
                                    eig_dtype=f32("eig_dtype"),
                                    knn_dtype=f32("knn_dtype"))
        return {"spectral_distance": o["spectral_distance"]}
    if st == "symmetry":
        o = analysis.run_symmetry(ca, m, matches, out_prefix=out_prefix,
                                  scan_dtype=f32("scan_dtype"))
        return {"rows": o["rows"]}
    if st == "spatial-stats":
        o = analysis.run_spatial_stats(ca, m, out_prefix=out_prefix,
                                       stat_dtype=f32("stat_dtype"), mesh=mesh)
        return {"hausdorff": o["hausdorff"]}
    if st == "report":
        return {"report_row": analysis.run_report(c, m, ca, matches, out_prefix)}
    if st == "coupling":
        from cmtci.pipelines.coupling import CouplingConfig, run_coupling

        rows, _ = run_coupling(
            c, m, matches,
            CouplingConfig(field_dtype=opts.get("field_dtype", "float64"),
                           vario_dtype=opts.get("vario_dtype", "float64")),
            out_prefix, mesh=mesh)
        return {"coupling_rows": rows}
    raise ValueError(f"unknown bus stage {st!r}")


def _run_suite(args) -> int:
    """All seven bus analyses in ONE process, per-stage timed.

    The per-command CLI pays python+jax startup per stage — ~3-5 s
    each, over half the measured 7-stage wall at the 6x bus (VALIDATION.md).
    One process shares startup, the loaded bus, and warm in-process jit
    caches; every stage runs the same pipeline call with the same
    out-prefix artifact layout as its standalone subcommand
    (`{out}/{stage}_*`), so outputs are value-identical per stage.
    """
    import time

    from cmtci.io.writers import to_jsonable

    t0 = time.time()
    stages = (_SUITE_STAGES if args.stages == "all"
              else tuple(s.strip() for s in args.stages.split(",") if s.strip()))
    unknown = [s for s in stages if s not in _SUITE_STAGES]
    if unknown:
        raise SystemExit(f"suite: unknown stage(s) {unknown}; choose from "
                         f"{list(_SUITE_STAGES)}")
    accel = args.device == "accel"
    c, m, ca, matches = _load_bus(args.busdir)
    timer = _timer(args)
    summary: dict = {}
    for st in stages:
        with timer.stage(st):
            opts = _ACCEL_STAGE_OPTS.get(st, {}) if accel else {}
            try:
                o = _run_bus_stage(st, c, m, ca, matches, f"{args.out}/{st}",
                                   opts, mesh=_mesh_from_args(args))
            except ValueError as e:
                # the device heads guard loudly against sizes past their
                # exact-count bounds (e.g. the 65536-point signed-int32
                # pair-count limit); a suite run must degrade to the host
                # path for THAT stage, not abort the remaining stages
                if not (accel and opts):
                    raise
                import sys

                print(f"suite: {st} accel path rejected ({e}); "
                      "rerunning this stage on the host path", file=sys.stderr)
                o = _run_bus_stage(st, c, m, ca, matches, f"{args.out}/{st}",
                                   {})
        if st == "spectral" and o["power_slopes_bootstrap"]:
            summary["power_slope_construct"] = o["power_slopes_bootstrap"][0]["slope"]
        elif st == "embeddings":
            summary["spectral_distance"] = o["spectral_distance"]
        elif st == "symmetry":
            summary["best_axis_deg"] = o["rows"][-1]["angle_deg"]
        elif st == "spatial-stats":
            summary["hausdorff"] = o["hausdorff"]
        elif st == "report":
            summary.setdefault("hausdorff", o["report_row"]["hausdorff"])
        elif st == "coupling":
            summary["coupling_d_mean"] = o["coupling_rows"][-1]["d_mean"]
    print(json.dumps(to_jsonable(
        {"stages": {k: round(v, 3) for k, v in timer.times.items()},
         "wall_s": round(time.time() - t0, 3), **summary})))
    return 0


def _load_bus(busdir):
    from cmtci.io.loaders import load_matches, load_points

    c = load_points(f"{busdir}/construct_points.csv")
    m = load_points(f"{busdir}/mandel_boundary_sample.csv")
    ca = load_points(f"{busdir}/construct_aligned.csv")
    try:
        matches = load_matches(f"{busdir}/matches_indices.csv", len(ca))
    except Exception:
        matches = None
    return c, m, ca, matches


def _dispatch(args):
    cmd = args.cmd
    if cmd == "boundary":
        from cmtci.pipelines.boundary import BoundaryConfig, run_boundary

        cfg = BoundaryConfig(tuple(args.xlim), tuple(args.ylim), args.res,
                             args.max_iter, args.level,
                             backend="xla" if args.parity else "auto")
        path, _ = run_boundary(cfg, args.out, mesh=_mesh_from_args(args))
        print(f"boundary: {len(path)} vertices -> {args.out}_boundary.csv")
    elif cmd == "lucas-boundary":
        from cmtci.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary

        cfg = LucasBoundaryConfig(args.n_min, args.n_max, args.alpha, args.n_boundary)
        xy = export_lucas_boundary(cfg, f"{args.out}_lucas_points.npy",
                                   cache_dir=args.cache_dir)
        print(f"lucas boundary: {xy.shape} -> {args.out}_lucas_points.npy")
    elif cmd == "construct-boundary":
        from cmtci.io.loaders import load_points
        from cmtci.pipelines.lucas_boundary import ConstructBoundaryConfig, construct_boundary

        pts = load_points(args.input_csv)
        b, closed = construct_boundary(pts, ConstructBoundaryConfig(args.alpha, args.target_n), args.out)
        print(f"construct boundary: {len(b)} pts closed={closed}")
    elif cmd == "curvature":
        from cmtci.io.loaders import load_points
        from cmtci.pipelines.curvature import CurvatureConfig, run_curvature

        pts = load_points(args.input_csv)
        _, _, _, _, summary = run_curvature(pts, CurvatureConfig(args.neighbors, args.closed), args.out)
        print(json.dumps(summary))
    elif cmd == "stage1":
        from cmtci.pipelines.stage1 import Stage1Config, run_stage1

        out = run_stage1(Stage1Config(max_n=args.max_n, boundary_samples=args.boundary_samples), args.out)
        print(f"stage1: C={out['C'].shape} M={out['M'].shape} -> {args.out}/")
    elif cmd == "tracker":
        from cmtci.pipelines.tracker import TrackerConfig, run_tracker, write_outputs

        domain = tuple(float(x) for x in args.domain.split(":"))
        if len(domain) != 4:
            raise SystemExit(
                f"--domain expects xmin:xmax:ymin:ymax (4 fields), got {args.domain!r}")
        cfg = TrackerConfig(seed=args.seed, domain=domain, alpha=args.alpha,
                            bins_start=args.bins_start, bins_max=args.bins_max,
                            sigma_bins=args.sigma_bins, t_fixed=args.t_fixed,
                            parity=args.parity, field_dtype=args.field_dtype,
                            de_impl=args.de_impl)
        rows, meta = run_tracker(cfg, mesh=_mesh_from_args(args),
                                 cache_dir=args.cache_dir,
                                 timer=_timer(args))
        csv_path, json_path = write_outputs(rows, meta, args.out)
        print(f"tracker: {len(rows)} stages -> {csv_path}")
    elif cmd == "tci":
        from cmtci.pipelines.analysis import TCIConfig, run_tci

        cfg = TCIConfig(mandelbrot_grid=args.grid, mandelbrot_samples=args.samples,
                        t_steps=args.t_steps, de_impl=args.de_impl)
        out, kls, _ = run_tci(cfg, f"{args.out}_tci_results.json")
        print(json.dumps(out))
    elif cmd == "equipotential":
        from cmtci.pipelines.equipotential import EquipotentialConfig, run_equipotential

        cfg = EquipotentialConfig(n_min=args.n_min, n_max=args.n_max,
                                  max_iter=args.max_iter,
                                  potential_dtype=args.green_dtype,
                                  curve_npy=args.curve_npy)
        out = run_equipotential(cfg, args.out, with_per_n=not args.skip_per_n,
                                cache_dir=args.cache_dir, timer=_timer(args),
                                mesh=_mesh_from_args(args))
        print(json.dumps(out["summary"]))
    elif cmd == "variograms":
        from cmtci.pipelines.variograms import VariogramConfig, run_variograms

        cfg = VariogramConfig(grid_nx=args.grid, grid_ny=args.grid,
                              detrend=args.detrend, fit_model=args.fit_model,
                              vario_dtype=args.vario_dtype,
                              field_dtype=args.field_dtype)
        out = run_variograms(cfg, f"{args.out}_variograms.csv",
                             mesh=_mesh_from_args(args))
        print(f"variograms: {out['n_construct']} C pts, {out['n_boundary']} M pts")
    elif cmd in _SUITE_STAGES:
        c, m, ca, matches = _load_bus(args.busdir)
        out = _run_bus_stage(cmd, c, m, ca, matches, args.out,
                             _bus_stage_opts_from_args(cmd, args),
                             mesh=_mesh_from_args(args))
        if cmd == "spectral":
            print(json.dumps(out["power_slopes_bootstrap"]))
        elif cmd == "multifractal":
            print("multifractal done")
        elif cmd == "embeddings":
            print(f"spectral distance: {out['spectral_distance']}")
        elif cmd == "symmetry":
            print(json.dumps(out["rows"][-1]))
        elif cmd == "spatial-stats":
            print(f"hausdorff={out['hausdorff']:.4f}")
        elif cmd == "report":
            print(json.dumps(out["report_row"]))
        elif cmd == "coupling":
            print(json.dumps(out["coupling_rows"][-1]))
    elif cmd == "suite":
        return _run_suite(args)
    elif cmd == "uniformize-fem":
        from cmtci.pipelines.uniformize_fem import (
            REFINEMENT_LEVELS, FEMUniformizeConfig, run_fem_uniformization,
        )

        cfg = FEMUniformizeConfig(
            solver=("spsolve" if args.parity else None)
            if args.solver == "auto" else args.solver)
        results = run_fem_uniformization(cfg, args.out, REFINEMENT_LEVELS[: args.levels])
        print(json.dumps({"levels": len(results), "K_median_L0": results[0]["all"]["K_median"]}))
    elif cmd == "uniformize-green":
        from cmtci.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary
        from cmtci.pipelines.uniformize_green import GreenUniformizeConfig, run_green_uniformization

        if args.lucas_npy:
            pts = np.load(args.lucas_npy)
        else:
            pts = export_lucas_boundary(LucasBoundaryConfig())
        cfg = GreenUniformizeConfig(n_bdy=args.n_bdy, interior_n=args.interior_n,
                                    map_dtype=args.map_dtype)
        out = run_green_uniformization(pts, cfg, args.out, verbose=True,
                                       cache_dir=args.cache_dir, timer=_timer(args))
        print(json.dumps({k: v for k, v in out["diagnostics"].items()
                          if k.startswith(("bdy_mod", "inverse_err"))}))
    elif cmd == "doctor":
        print(json.dumps(_doctor(smoke=args.smoke), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
