"""Real-weights study cell on the PyTorch port: a learned model whose
generation lengths are driven by the EOS it emits itself.

Run on a machine with a CUDA card:

    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch examples/torch_llm_energy_real_weights.py
    python examples/torch_llm_energy_real_weights.py   # the same

The study's 7 families run from random weights (nothing is downloaded),
so their generations always run to the token budget. This cell uses the
port's own trained tiny LM (``models/tiny_lm.py``): it learned an in-repo
corpus and emits EOS, so ``generated_tokens`` varies per row and stays
below the budget, and the per-run artifacts hold readable text. The
weights are trained once on the card with the port's train step and
checkpointed (safetensors) under the output directory; re-runs load them.
Both locations run on one ``TorchEngine`` in f32 on the card, its
attention through the port's kernels at head width 32.
"""

import sys
from pathlib import Path

import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments.llm_energy import (
    LlmEnergyConfig,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.tiny_lm import (
    TINY_LM_NAME,
    load_or_train_tiny_lm,
)

CKPT_DIR = Path("experiments_output") / "tiny_lm_weights"


class RunnerConfig(LlmEnergyConfig):
    """The cell: the trained tiny LM, both locations, 100 words, three
    repetitions; keyword arguments override any of these."""

    def __init__(self, **overrides):
        cfg, params = load_or_train_tiny_lm(CKPT_DIR, log_every=100)
        engine = TorchEngine(registry={}, dtype=torch.float32)
        engine.install_model(TINY_LM_NAME, cfg, params)
        settings = dict(
            models=[TINY_LM_NAME],
            lengths=[100],
            repetitions=3,
            cooldown_ms=500,
            results_output_path=Path("experiments_output"),
            backends={"on_device": engine, "remote": engine},
        )
        settings.update(overrides)
        super().__init__(**settings)


def main() -> int:
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.cli import main as cli_main

    return cli_main([__file__])


if __name__ == "__main__":
    sys.exit(main())
