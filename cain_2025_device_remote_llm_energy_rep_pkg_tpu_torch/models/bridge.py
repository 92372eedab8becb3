"""Bridge from the JAX package's parameters to the port's.

The JAX params arrive as numpy arrays (``jax.tree.map(np.asarray,
params)``): plain arrays, or quantized dicts — int8 ``{"q", "s"}``, int4
``{"q4", "s"}`` (int8 codes) and int4-i32 ``{"q32", "s"}`` (int32 codes).
Both packages keep the same leaf names and the same stacked ``[L, ...]``
layout, so the bridge is a plain copy; it imports no jax.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .quantize import is_quantized


def _tensor(a: Any, device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype in (np.int8, np.int32):  # quantized codes, carried exactly
        return torch.from_numpy(arr.copy()).to(device)
    # bf16 arrays come as ml_dtypes.bfloat16, which torch cannot wrap;
    # widening to float32 is exact, and the cast to ``dtype`` then matches.
    return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)


def params_from_numpy(
    np_params: Dict[str, Any], device="cpu", dtype: torch.dtype = torch.float32
) -> Dict[str, Any]:
    """JAX-layout numpy params → the port's tensors on ``device``.
    Plain leaves take ``dtype``; codes keep their int8 or int32 and scales
    are float32."""
    out: Dict[str, Any] = {}
    for name, leaf in np_params.items():
        if isinstance(leaf, dict):
            if not is_quantized(leaf):
                raise ValueError(f"{name}: not a quantized leaf, got keys {sorted(leaf)}")
            out[name] = {k: _tensor(v, device, torch.float32) for k, v in leaf.items()}
        else:
            out[name] = _tensor(leaf, device, dtype)
    return out
