"""Smoke-test variant of the energy study on the PyTorch port: 2 tiny
models, 1 length, 2 reps.

Runs in a couple of minutes on a machine with a CUDA card:
    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch examples/torch_llm_energy_smoke.py
    python examples/torch_llm_energy_smoke.py   # the same

Both models are ``.tiny(max_seq_len=1024)`` at f32 with seeded random
weights: qwen2:1.5b's 4 query heads over 2 KV heads and gemma:2b's 8 over
1, each of width 16, which the port's attention kernels take natively.
"""

import sys
from pathlib import Path

import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments.llm_energy import (
    LlmEnergyConfig,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config,
)

_MODELS = ["qwen2:1.5b", "gemma:2b"]
_REGISTRY = {name: get_model_config(name).tiny(max_seq_len=1024) for name in _MODELS}


class RunnerConfig(LlmEnergyConfig):
    def __init__(self):
        engine = TorchEngine(registry=_REGISTRY, dtype=torch.float32)  # the card: raises without one
        super().__init__(
            models=_MODELS,
            lengths=[100],
            repetitions=2,
            cooldown_ms=500,
            results_output_path=Path("experiments_output"),
            backends={"on_device": engine, "remote": engine},
            # Tiny models make the 8-GPU node model meaningless: the
            # roofline says a toy model's decode step sits on the
            # interconnect's latency floor, so aliased remote rows would
            # be billed absurd node windows. The smoke serves both
            # treatments from one card; the real topology belongs to the
            # full study (torch_llm_energy_study.py).
            n_chips_by_location={"on_device": 1, "remote": 1},
        )


def main() -> int:
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.cli import main as cli_main

    return cli_main([__file__])


if __name__ == "__main__":
    sys.exit(main())
