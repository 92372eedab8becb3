"""A custom experiment on the PyTorch port showing the framework's
general-purpose surface: any measured activity, any factors, any
profilers — not just LLM energy.

Measures matrix-multiply throughput on the CUDA card across sizes and
dtypes:
    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch examples/torch_custom_experiment.py
    python examples/torch_custom_experiment.py   # the same
"""

import sys
import time
from pathlib import Path

import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch import (
    ExperimentConfig,
    Factor,
    RunTableModel,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers import (
    HostResourceProfiler,
)

DEVICE = torch.device("cuda")  # the card: the experiment refuses to start without one


def _synchronize() -> None:
    """Wait for the device: CUDA calls return before the card finishes."""
    if DEVICE.type == "cuda":
        torch.cuda.synchronize(DEVICE)


class RunnerConfig(ExperimentConfig):
    name = "matmul_throughput"
    results_output_path = Path("experiments_output")
    time_between_runs_in_ms = 1000
    isolate_runs = False  # a forked run cannot use CUDA
    profilers = [HostResourceProfiler(period_s=0.2)]

    def create_run_table_model(self) -> RunTableModel:
        return RunTableModel(
            factors=[
                Factor("size", [512, 1024, 2048]),
                Factor("dtype", ["float32", "bfloat16"]),
            ],
            repetitions=3,
            data_columns=["tflops", "wall_s"],
            shuffle=True,
        )

    def before_experiment(self) -> None:
        if DEVICE.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{self.name} times matmuls on a CUDA device and none is available")

    def interact(self, context):
        n = context.factor("size")
        dtype = getattr(torch, context.factor("dtype"))
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        x = torch.randn((n, n), generator=gen, device=DEVICE).to(dtype)
        torch.matmul(x, x)  # warm up outside the timed region
        _synchronize()
        t0 = time.monotonic()
        iters = 10
        for _ in range(iters):
            y = torch.matmul(x, x)
        _synchronize()
        wall = time.monotonic() - t0
        del y
        context.scratch["wall_s"] = wall
        context.scratch["tflops"] = 2 * n**3 * iters / wall / 1e12

    def populate_run_data(self, context):
        return {
            "tflops": round(context.scratch["tflops"], 3),
            "wall_s": round(context.scratch["wall_s"], 4),
        }


def main() -> int:
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.cli import main as cli_main

    return cli_main([__file__])


if __name__ == "__main__":
    sys.exit(main())
