"""Multi-host process-group helpers.

Counterpart of the JAX package's ``parallel/distributed.py``. The
reference's only cross-machine mechanism is an HTTP POST to an Ollama
server whose address comes from ``.env SERVER_IP``
(experiment/RunnerConfig.py:122-131). The JAX package joins a
``jax.distributed`` runtime; the port joins a ``torch.distributed``
process group, configured by the same ``.env`` keys. Within one host the
port's sharded engine needs no process group (``parallel/tp.py`` drives
every shard from one process).

Env keys (``.env`` or process env):
  COORDINATOR_ADDRESS  host:port of process 0       (reference: SERVER_IP)
  NUM_PROCESSES        total process count
  PROCESS_ID           this process's index
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..runner import term
from ..utils.env import load_dotenv


def distributed_config_from_env(dotenv_path: Optional[Path] = None) -> Optional[dict]:
    """Read coordinator settings; None when not configured (single host)."""
    load_dotenv(dotenv_path)
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if not addr:
        return None
    return {
        "coordinator_address": addr,
        "num_processes": int(os.environ.get("NUM_PROCESSES", "1")),
        "process_id": int(os.environ.get("PROCESS_ID", "0")),
    }


def initialize_distributed(dotenv_path: Optional[Path] = None) -> bool:
    """Join the process group the env describes; no-op on a single host.

    ``torch.distributed.init_process_group`` over ``tcp://`` the
    coordinator's address: NCCL when this process sees a GPU, gloo on a
    CPU-only host. An NCCL failure raises; it never falls back to gloo.
    Returns True when a multi-process group was joined (also when this
    process had joined it already)."""
    config = distributed_config_from_env(dotenv_path)
    if config is None:
        return False
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{config['coordinator_address']}",
        world_size=config["num_processes"],
        rank=config["process_id"],
    )
    term.log_ok(
        f"joined distributed runtime ({backend}): process {config['process_id']}/"
        f"{config['num_processes']} via {config['coordinator_address']}"
    )
    return True


def is_coordinator() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def global_device_summary() -> str:
    import torch
    import torch.distributed as dist

    processes = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return f"{processes} process(es), {local} local GPU(s) each"
