"""Per-stage artifact store keyed by config hash (checkpoint/resume, SURVEY §5.4).

The reference checkpoints only at file-bus granularity (each script reloads
its predecessors' CSVs; v18 skips regenerating lucas_points.npy if present).
Here any pipeline stage can be wrapped in `cached(...)`: the result is
stored as an .npz keyed by a stable hash of the config dict, so reruns with
identical parameters resume instantly and parameter changes invalidate
automatically.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


def config_key(config: dict) -> str:
    """Stable short hash of a JSON-serializable config dict."""
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def array_digest(arr) -> str:
    """Short content hash of an array, for keying caches on array inputs."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def rng_state_arrays(rng: "np.random.RandomState") -> dict:
    """MT19937 state of a RandomState as npz-storable arrays."""
    name, keys, pos, has_gauss, cached = rng.get_state()
    assert name == "MT19937"
    return {"rng_keys": keys, "rng_pos": np.int64(pos),
            "rng_has_gauss": np.int64(has_gauss), "rng_cached": np.float64(cached)}


def restore_rng_state(rng: "np.random.RandomState", blob: dict) -> None:
    rng.set_state(("MT19937", np.asarray(blob["rng_keys"], dtype=np.uint32),
                   int(blob["rng_pos"]), int(blob["rng_has_gauss"]),
                   float(blob["rng_cached"])))


def cached(stage: str, config: dict, fn, cache_dir: str = ".cmtci_cache",
           enabled: bool = True):
    """Run fn() -> dict[str, array] with npz caching keyed by (stage, config)."""
    if not enabled:
        return fn()
    key = config_key({"stage": stage, **config})
    path = os.path.join(cache_dir, f"{stage}_{key}.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    out = fn()
    os.makedirs(cache_dir, exist_ok=True)
    # unique tmp per writer: concurrent misses on the same key (thread
    # fan-outs, parallel runs sharing a cache dir) must not interleave
    # writes on one inode before the atomic publish
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in out.items()})
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return out


import threading as _threading

_fetch_bytes = [0, 0]  # process-wide tallies: [all jax.Array, accelerator-only]
_fetch_lock = _threading.Lock()  # fetches can race since the tracker's
# cloud/sample overlap introduced a concurrent window; unsynchronized
# increments could silently undercount and mask a transfer regression


def fetch(x) -> np.ndarray:
    """np.asarray with device->host transfer accounting.

    Every hot-path device fetch goes through here so StageTimer can report
    bytes moved per stage — per-stage transfer volume is a perf metric and
    a silent regression (e.g. a grid-sized mask where n_samples indices
    suffice) should show up mechanically, not in a hand profile. Two
    tallies: every jax.Array fetch (the host-CPU jax backend included),
    and accelerator-only fetches — the ones that cross the host bus. Host
    numpy passes through untallied.
    """
    import jax

    is_device = isinstance(x, jax.Array)
    accel = is_device and any(d.platform != "cpu" for d in x.devices())
    out = np.asarray(x)
    if is_device:
        with _fetch_lock:
            _fetch_bytes[0] += out.nbytes
            if accel:
                _fetch_bytes[1] += out.nbytes
    return out


def fetch_bytes_total() -> int:
    """Process-wide bytes fetched through fetch() from any jax backend."""
    return _fetch_bytes[0]


def accel_bytes_total() -> int:
    """Process-wide bytes fetched from non-CPU (accelerator) devices only —
    the device→host traffic of a GPU session."""
    return _fetch_bytes[1]


class StageTimer:
    """Per-stage wall timing + device->host transfer bytes, with optional
    jax.profiler traces (SURVEY §5.1). Transfer accounting covers fetches
    routed through `fetch()` (all cmtci hot paths): `self.bytes[name]` is
    every jax.Array fetch (incl. the host-CPU jax backend), and
    `self.accel_bytes[name]` only the accelerator ones — the number to
    watch for transfer regressions on a GPU session."""

    def __init__(self, trace_dir: str | None = None):
        self.times: dict = {}
        self.bytes: dict = {}
        self.accel_bytes: dict = {}
        self.trace_dir = trace_dir

    def stage(self, name: str):
        import contextlib
        import time

        timer = self

        @contextlib.contextmanager
        def _cm():
            ctx = None
            if timer.trace_dir:
                import jax

                ctx = jax.profiler.trace(timer.trace_dir)
                ctx.__enter__()
            t0 = time.time()
            with _fetch_lock:
                b0, a0 = _fetch_bytes
            try:
                yield
            finally:
                timer.times[name] = timer.times.get(name, 0.0) + time.time() - t0
                with _fetch_lock:
                    b1, a1 = _fetch_bytes
                timer.bytes[name] = timer.bytes.get(name, 0) + b1 - b0
                timer.accel_bytes[name] = (timer.accel_bytes.get(name, 0)
                                           + a1 - a0)
                if ctx is not None:
                    ctx.__exit__(None, None, None)

        return _cm()
