"""Multi-PROCESS (multi-controller) distributed SpGEMM.

The single-process tests (test_distributed.py) run the shard_map routes
over a virtual 8-device mesh inside one process; here the same routes run
across 2 OS processes x 2 CPU devices each (4 global devices), with JAX's
coordination service + Gloo doing the cross-process collectives — the
actual multi-host execution model of a GPU cluster (one controller per
host), which the reference cannot express at all (SURVEY.md §2.7: no
distributed backend).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env():
    env = dict(os.environ)
    # the children import the package from the repo and run on the CPU
    # backend with two virtual devices each
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    return env


def test_two_process_dist_and_ring(tmp_path):
    # a port the OS says is free right now (child 0 binds it moments
    # later; pid-hash ports collided with leaked coordinators)
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = _child_env()
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", "-m", "ia_spgemm_tpu.parallel.multihost",
             str(pid), "2", str(port)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
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
        assert p.returncode == 0, f"proc {pid} rc={p.returncode}:\n{out}"
        assert "MULTIPROC_OK" in out, f"proc {pid}:\n{out}"
        assert "dist ok" in out and "ring ok" in out
