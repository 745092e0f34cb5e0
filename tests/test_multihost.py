"""2-process jax.distributed smoke test (SURVEY.md §5 distributed backend):
the multi-host path must have an executable proof without accelerators.

Spawns two CPU-backend subprocesses that rendezvous through
parallel.cluster.initialize, build a global 2-device mesh, shard a ray
batch with local_ray_slice + host_local_array_to_global_array, run the
sharded trace, and each check their local shard against a single-process
oracle."""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_trace():
    # Bounded by communicate(timeout=540) below; no pytest-timeout here.
    port = _free_port()
    env = dict(os.environ)
    # The worker pins JAX_PLATFORMS=cpu and its device count itself.
    env["PYTHONPATH"] = REPO
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK pid={pid}" in out
