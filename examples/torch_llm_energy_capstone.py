"""The capstone study on the PyTorch port, with the reference's
client/server split: the FULL protocol (7 model families × 2 locations ×
3 content lengths × 30 repetitions, 1,260 runs,
experiment/RunnerConfig.py:80-88) against the port's own HTTP server on
one NVIDIA H100. The reference's on-device treatment curls a local Ollama
server and its remote treatment another machine's
(experiment/RunnerConfig.py:122-131); here both are HTTP clients of the
server that owns the card:

  terminal 1 (owns the card):
    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch serve \\
        --host 127.0.0.1 --port 11434 \\
        --quantize "qwen2:1.5b=int8,gemma:2b=int8,default=int4"

  terminal 2 (a pure HTTP client; it never touches the card):
    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch \\
        examples/torch_llm_energy_capstone.py

Every generation crosses a process and socket boundary, and the run
table's ``backend`` column records the URL of each row. With one host
the remote treatment's hop is loopback: both locations name the same
URL, so the remote rows are recorded as aliased and their serving
energy is modelled as an 8-GPU node (``parallel/roofline.py``). The
client records host energy only: the card's NVML Joules belong to the
serving process. Quantization: the two small models at int8, phi3:3.8b
and up at int4, as Ollama's default 4-bit quants do for large models.
The cooldown follows the channel-typed policy (the reference's 90 s
wherever a measured host channel is active, else 2 s).
"""

import os
import sys
from pathlib import Path

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments.llm_energy import (
    LlmEnergyConfig,
)

SERVER_URL = os.environ.get("CAPSTONE_SERVER_URL", "http://127.0.0.1:11434")

# The reference's sweep (experiment/RunnerConfig.py:80): all 7 families.
CAPSTONE_MODELS = [
    "qwen2:1.5b",
    "gemma:2b",
    "phi3:3.8b",
    "gemma:7b",
    "qwen2:7b",
    "mistral:7b",
    "llama3.1:8b",
]
# What the `serve` process above serves, recorded in the study's metadata.
CAPSTONE_QUANT = {"qwen2:1.5b": "int8", "gemma:2b": "int8", "default": "int4"}


class RunnerConfig(LlmEnergyConfig):
    def __init__(self):
        super().__init__(
            models=CAPSTONE_MODELS,
            lengths=[100, 500, 1000],
            repetitions=30,
            results_output_path=Path("experiments_output"),
            on_device_url=SERVER_URL,
            remote_url=SERVER_URL,
            quantize=CAPSTONE_QUANT,
        )


def main() -> int:
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.cli import main as cli_main

    return cli_main([__file__])


if __name__ == "__main__":
    sys.exit(main())
