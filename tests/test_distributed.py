"""Multi-host smoke: 2-process jax.distributed over a local coordinator.

VERDICT r4 item 8 — parallel/distributed.initialize had no test at all.
Each subprocess pins the CPU backend, initializes against a local
coordinator, builds the cross-process device mesh with
parallel.sharded.device_mesh, and runs ONE psum across both processes'
devices; process 0 asserts the globally-reduced value. This exercises the
actual DCN code path (jax.distributed + a collective through shard_map)
without accelerator hardware.
"""

import os
import subprocess
import sys
import socket

import pytest

_CHILD = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

from cmtci.parallel.distributed import initialize, process_info
from cmtci.parallel.sharded import device_mesh

coord, pid = sys.argv[1], int(sys.argv[2])
assert initialize(coordinator_address=coord, num_processes=2,
                  process_id=pid, require=True)
info = process_info()
assert info["process_count"] == 2, info
assert info["global_devices"] == 4, info  # 2 hosts x 2 virtual devices

import functools
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

mesh = device_mesh()  # all 4 global devices

@functools.partial(shard_map, mesh=mesh, in_specs=P("data"), out_specs=P(),
                   check_vma=False)
def global_sum(x):
    return jax.lax.psum(jnp.sum(x), "data")

# every process contributes its local shard of the same global array
x = jax.make_array_from_callback(
    (8,), NamedSharding(mesh, P("data")),
    lambda idx: np.arange(8, dtype=np.float64)[idx])
total = float(global_sum(x))
assert total == 28.0, total  # sum(range(8)) across BOTH processes
print(f"proc {pid} ok total={total} info={info}", flush=True)
"""


def test_two_process_psum(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = "/root/repo" + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen([sys.executable, str(script), coord, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd="/root/repo")
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"distributed smoke timed out; partial output: {outs}")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} ok total=28.0" in out, out[-3000:]
