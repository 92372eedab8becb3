"""One repetition of every cell of the study on the PyTorch port, on one
NVIDIA H100: the data the energy model's calibration against NVML fits.

Run from the repository root with:
    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch examples/torch_llm_energy_sweep.py
or, the same run with an output directory:
    PYTHONPATH=. python examples/torch_llm_energy_sweep.py [out_dir]

The 21 ``on_device`` cells (the study's 7 models × 100, 500 and 1,000
words) and the 7 ``remote`` cells at 100 words (served by the same card,
billed as an 8-GPU node, marked ``[aliased-on_device]``), one repetition
each, in the table's order, int8 weights with a bf16 KV cache, full
published widths with random weights from a seed (no download), and a 2 s
cooldown instead of the reference's 90 s. The output directory (default
``experiments_output``, or the ``TORCH_SWEEP_OUT`` environment variable,
which ``out_dir`` sets) holds ``llm_energy_cuda_sweep/`` with
``run_table.csv`` and the analysis report. The runner resumes an
interrupted table from the same directory (``runner/resume.py``): rerun
the same command to finish the rows not yet done.
"""

import os
import sys
from pathlib import Path

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments.llm_energy import (
    LENGTHS,
    LlmEnergyConfig,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.factors import RunTableModel


class RunnerConfig(LlmEnergyConfig):
    name = "llm_energy_cuda_sweep"

    def __init__(self):
        super().__init__(
            repetitions=1,
            cooldown_ms=2000,
            shuffle=False,
            results_output_path=Path(os.environ.get("TORCH_SWEEP_OUT", "experiments_output")),
        )

    def create_run_table_model(self) -> RunTableModel:
        model = super().create_run_table_model()
        # remote at 100 words only
        return RunTableModel(
            factors=model.factors,
            repetitions=model.repetitions,
            data_columns=model.data_columns,
            exclusions=[{"location": ["remote"], "length": LENGTHS[1:]}],
            shuffle=model.shuffle,
            shuffle_seed=model.shuffle_seed,
        )


def main() -> int:
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.cli import main as cli_main

    if len(sys.argv) > 1:
        os.environ["TORCH_SWEEP_OUT"] = sys.argv[1]
    return cli_main([__file__])


if __name__ == "__main__":
    sys.exit(main())
