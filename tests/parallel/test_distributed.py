"""Real multi-process ``jax.distributed`` exercise (SURVEY §4 carry-over).

Spawns two CPU processes that initialise through
``parallel.distributed.initialize_distributed`` against a localhost
coordinator and reduce a host-local scalar with ``all_hosts_mean``; each
process must see process_count==2 and agree on the cross-host mean —
the actual multi-host code path, not the virtual single-process mesh.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_workers(addr, env):
    """Run both workers to completion; returns (ok, outs, last_err)."""
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, addr, "2", str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs, last_err = [], ""
    ok = True
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            ok, last_err = False, err
        else:
            outs.append(json.loads(out.strip().splitlines()[-1]))
    return ok, outs, last_err


def test_two_process_distributed_mean():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    # _free_port closes the probe socket before the coordinator binds it
    # (TOCTOU): another process can grab the port in between, so a bind
    # failure retries the whole spawn with a fresh port.
    last_err = ""
    for _ in range(3):
        ok, outs, last_err = _spawn_workers(f"127.0.0.1:{_free_port()}", env)
        if ok:
            break
    assert ok, f"workers failed on 3 ports:\n{last_err}"

    for pid, o in enumerate(outs):
        assert o["initialized"] is True
        assert o["process_count"] == 2
        assert o["process_index"] == pid
        # mean of host-local scalars 1.0 (proc 0) and 2.0 (proc 1)
        assert o["mean"] == pytest.approx(1.5)


def test_single_process_is_a_no_op(monkeypatch):
    import jax

    from tile_match_tpu.parallel.distributed import initialize_distributed

    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert jax.process_count() == 1
