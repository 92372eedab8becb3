"""The port's process group: ``tests/test_distributed.py``'s boundary on
``torch.distributed``.

Two fresh CPU processes join one group through
``parallel/distributed.py::initialize_distributed`` (gloo: they see no
GPU), configured by the JAX package's env keys, and agree on one
``all_reduce`` (each adds ``rank + 1``: both read 3), the counterpart of
``test_two_process_group_psum``. The backend rule is pinned in-process:
NCCL where the process sees a GPU, and an NCCL failure raises rather
than falling back to gloo.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel import distributed

REPO_ROOT = Path(__file__).resolve().parent.parent

WORKER = r"""
import json

import torch
import torch.distributed as dist

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.distributed import (
    global_device_summary,
    initialize_distributed,
    is_coordinator,
)

assert initialize_distributed(), "COORDINATOR_ADDRESS was set; initialize must join"
assert initialize_distributed()  # a second call finds the group joined
t = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(t)
out = {
    "rank": dist.get_rank(),
    "world": dist.get_world_size(),
    "backend": dist.get_backend(),
    "is_coordinator": is_coordinator(),
    "sum": float(t[0]),
    "summary": global_device_summary(),
}
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_group_all_reduce():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2", PROCESS_ID=str(pid),
            PYTHONPATH=str(REPO_ROOT), CUDA_VISIBLE_DEVICES="",
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env, cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    results = {}
    for p in procs:
        out, err = p.communicate(timeout=150)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        line = next(line for line in out.splitlines() if line.startswith("RESULT "))
        r = json.loads(line[len("RESULT "):])
        results[r["rank"]] = r
    assert set(results) == {0, 1}
    for r in results.values():
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["sum"] == pytest.approx(3.0)  # 1 + 2 across the processes
    assert results[0]["is_coordinator"] and not results[1]["is_coordinator"]
    assert "2 process(es)" in results[0]["summary"]


def test_initialize_without_a_coordinator_joins_nothing(monkeypatch, tmp_path):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert distributed.initialize_distributed(tmp_path / "absent.env") is False
    assert distributed.is_coordinator()


def test_nccl_where_a_gpu_is_seen_and_no_gloo_fallback(monkeypatch, tmp_path):
    """A process that sees a GPU asks for NCCL; when NCCL fails the error
    reaches the caller, and no second, gloo group is tried."""
    import torch
    import torch.distributed as dist

    calls = []

    def init(**kwargs):
        calls.append(kwargs)
        raise RuntimeError("NCCL error: unhandled system error")

    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", init)
    with pytest.raises(RuntimeError, match="NCCL error"):
        distributed.initialize_distributed(tmp_path / "absent.env")
    assert calls == [dict(backend="nccl", init_method="tcp://127.0.0.1:1", world_size=2, rank=1)]
