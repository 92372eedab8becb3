"""The flagship study on the PyTorch port: on-device vs remote LLM
generation energy on one NVIDIA H100.

Run from the repository root with:
    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch examples/torch_llm_energy_study.py
or, the same run:
    PYTHONPATH=. python examples/torch_llm_energy_study.py

The full 7-model × 2-location × 3-length × 30-repetition sweep of the
reference (experiment/RunnerConfig.py:77-88) on ``TorchEngine`` at int8
weights: "on_device" serves from the card; "remote", without a server
named by ``remote_url`` or ``.env SERVER_IP``, is served by the same card
and billed by the energy model as an 8-GPU node (its rows are marked
``[aliased-on_device]``). NVML's energy counter gives the measured
``gpu_energy_J`` of every row; ``after_experiment`` analyses the table.
Expect many hours (90 s cooldown × 1,260 runs, like the original study).
The engine raises without a CUDA device. For one repetition of every
cell see ``torch_llm_energy_sweep.py``.
"""

import sys
from pathlib import Path

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments.llm_energy import (
    LlmEnergyConfig,
)


class RunnerConfig(LlmEnergyConfig):
    def __init__(self):
        super().__init__(
            repetitions=30,
            results_output_path=Path("experiments_output"),
        )


def main() -> int:
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.cli import main as cli_main

    return cli_main([__file__])


if __name__ == "__main__":
    sys.exit(main())
