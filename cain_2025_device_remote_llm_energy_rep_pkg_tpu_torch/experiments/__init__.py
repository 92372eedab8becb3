"""Study configs — the equivalent of the reference's ``experiment/`` dir."""

from .llm_energy import LlmEnergyConfig

__all__ = ["LlmEnergyConfig"]
