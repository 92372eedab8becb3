"""Model-weight checkpoints: save once, reload across runs and restarts.

The counterpart of the JAX package's ``engine/checkpoint.py`` (Orbax
there). Params are written in the safetensors layout: an 8-byte
little-endian header length, a JSON header naming each tensor's dtype,
shape and byte range, then the raw little-endian tensors. The port reads
and writes it itself (``json`` and ``torch.frombuffer``), so it needs
neither Orbax nor the ``safetensors`` package, and the files it writes
load with that package too. Quantized leaves (``{"q", "s"}``,
``{"q4", "s"}``, ``{"q32", "s"}``) flatten to dotted names (``wq.q``) and
come back as the same dicts with the same dtypes.

:class:`SafetensorsFile` reads one tensor at a time, so a caller can
convert a checkpoint leaf by leaf (``models/convert.py``).
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flatten(leaf, f"{prefix}{name}.")
        else:
            yield prefix + name, leaf


def save_params(params: Dict[str, Any], path: Path) -> Path:
    """Write a params tree (nested names join with ``.``) as one
    safetensors file, through a temporary file renamed into place;
    overwrites an existing checkpoint at ``path``."""
    path = Path(path).absolute()
    flat = [(name, t.detach().contiguous().cpu()) for name, t in _flatten(params)]
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in flat:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    tmp = path.with_name(path.name + ".tmp")
    with tmp.open("wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in flat:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)
    return path


class SafetensorsFile:
    """One safetensors file, its tensors read on demand."""

    def __init__(self, path: Path) -> None:
        self.path = Path(path)
        with self.path.open("rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._base = 8 + n
        header.pop("__metadata__", None)
        self.header = header

    def keys(self):
        return self.header.keys()

    def get(self, name: str, device="cpu", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Tensor ``name``, optionally cast to ``dtype``, on ``device``."""
        info = self.header[name]
        begin, end = info["data_offsets"]
        stored = _DTYPES[info["dtype"]]
        if end == begin:
            t = torch.empty(info["shape"], dtype=stored)
        else:
            buf = bytearray(end - begin)
            with self.path.open("rb") as f:
                f.seek(self._base + begin)
                f.readinto(buf)
            t = torch.frombuffer(buf, dtype=stored).reshape(info["shape"])
        return t.to(device=device, dtype=dtype or stored)


def load_params(path: Path, like: Optional[Dict[str, Any]] = None, device="cpu") -> Dict[str, Any]:
    """Restore a params tree. With ``like`` (a tree of the same structure)
    each leaf takes the dtype and device of its counterpart there; without
    it, the stored dtypes on ``device``."""
    f = SafetensorsFile(Path(path).absolute())
    out: Dict[str, Any] = {}
    for name in f.keys():
        *parents, leaf = name.split(".")
        node, ref = out, like
        for part in parents:
            node = node.setdefault(part, {})
            ref = None if ref is None else ref[part]
        target = None if ref is None else ref[leaf]
        if target is None:
            node[leaf] = f.get(name, device=device)
        else:
            node[leaf] = f.get(name, device=target.device, dtype=target.dtype)
    return out


class WeightCache:
    """Engine-facing cache: ``get_or_init(name, seed, init_fn)`` writes the
    first build of a model's params and restores it afterwards."""

    def __init__(self, cache_dir: Path) -> None:
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def path_for(self, model: str, seed: int, fingerprint: str = "") -> Path:
        safe = model.replace(":", "_").replace("/", "_")
        suffix = f"-{fingerprint}" if fingerprint else ""
        return self.cache_dir / f"{safe}-seed{seed}{suffix}.safetensors"

    def get_or_init(self, model: str, seed: int, init_fn, fingerprint: str = "", device="cpu") -> Dict[str, Any]:
        """``fingerprint`` must encode everything that shapes the params
        (config, dtype, source, quant mode): a stored file for another
        architecture or dtype must miss, not restore. A hit loads onto
        ``device``."""
        path = self.path_for(model, seed, fingerprint)
        if path.exists():
            return load_params(path, device=device)
        params = init_fn()
        save_params(params, path)
        return params
