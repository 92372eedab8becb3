"""Device meshes: named grids of ``torch.device``s.

Counterpart of the JAX package's ``parallel/mesh.py``, with the same axis
conventions:
  ``dp`` — data parallel (rows of a batch)
  ``tp`` — tensor parallel (attention heads, FFN hidden, vocabulary)
  ``sp`` — sequence parallel (ring attention's token-shard axis)
  ``ep`` — expert parallel (whole experts of a mixture-of-experts MLP)

A ``MeshSpec`` names the axes with sizes; ``build_mesh`` lays them over an
explicit device list, in mesh-major order. One device may be named more
than once: that is how a one-card machine holds several shards, each with
its own tensors on that card. Without a device list the mesh resolves
over the visible GPUs, so no caller gets a mesh on one card unless it
asks for one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes, in mesh-major order. -1 on exactly one axis means
    "all remaining devices"."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def tp_only(cls, tp: int = -1) -> "MeshSpec":
        return cls(axes=(("tp", tp),))

    @classmethod
    def dp_tp(cls, dp: int, tp: int) -> "MeshSpec":
        return cls(axes=(("dp", dp), ("tp", tp)))

    @classmethod
    def dp_tp_sp(cls, dp: int, tp: int, sp: int) -> "MeshSpec":
        return cls(axes=(("dp", dp), ("tp", tp), ("sp", sp)))

    @classmethod
    def tp_ep(cls, tp: int, ep: int) -> "MeshSpec":
        """Tensor × expert parallelism (MoE serving)."""
        return cls(axes=(("tp", tp), ("ep", ep)))

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        wild = [name for name, size in sizes.items() if size == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed: {self.axes}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {dict(self.axes)} needs {fixed} devices, have {n_devices}"
            )
        return sizes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices on a named grid: ``devices`` is flat, in mesh-major order
    over ``shape``'s axes."""

    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def axis(self, name: str) -> int:
        return int(self.shape.get(name, 1))

    def device_at(self, **coord: int) -> torch.device:
        """The device at ``coord`` (axes left out are at 0)."""
        flat = 0
        for name in self.axis_names:
            flat = flat * self.shape[name] + int(coord.get(name, 0))
        return self.devices[flat]


def visible_devices() -> List[torch.device]:
    """The GPUs this process sees (none on a CPU-only host)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(spec: MeshSpec, devices: Optional[Sequence] = None) -> Mesh:
    """Lay ``spec`` over ``devices`` (default: the visible GPUs), which
    must number what ``spec.resolve`` asks for; entries may repeat."""
    devices = [torch.device(d) for d in devices] if devices is not None else visible_devices()
    sizes = spec.resolve(len(devices))
    return Mesh(devices=tuple(devices), shape=dict(sizes))
