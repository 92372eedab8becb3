"""Build and load the port's CUDA kernels (``csrc/*.cu``) through ctypes.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library of
its own with a plain C interface, at first use, under ``_build/`` beside the
package (git-ignored). :func:`build` starts one ``nvcc`` per source at once
and waits for all of them. A library's name carries a digest of its source
and of every shared header (``csrc/*.cuh``), so an edited kernel never
loads a stale build. Nothing here runs at import: the CPU tests import
every module on a machine without ``nvcc``. :func:`tickets` holds the
ticket scratch that the one-launch kernels share.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
SOURCES = {p.stem: p for p in sorted(CSRC.glob("*.cu"))}
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_p, _i = ctypes.c_void_p, ctypes.c_int
# The C entry points of each library: name -> (argtypes, restype).
_SIGNATURES = {
    "attention": {
        "attn_error_string": ([_i], ctypes.c_char_p),
        "attn_prefill_rows": ([], _i),
        "attn_decode_group_max": ([], _i),
        "attn_prefill_splits": ([_i, _i, _i, _i, _i, _i, _i], _i),
        "attn_prefill": ([_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p], _i),
        "attn_decode": (
            [_i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p], _i,
        ),
    },
    "paged_attention": {
        "paged_error_string": ([_i], ctypes.c_char_p),
        "paged_group_max": ([], _i),
        "paged_parts": ([_i] + [_p] * 13 + [_i] * 8 + [_p], _i),
        "paged_decode": (
            [_i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p], _i,
        ),
        "paged_mq_query_max": ([_i], _i),
        "paged_mq_parts": (
            [_i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
             _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p],
            _i,
        ),
        "paged_mq_mma_parts": ([_p] * 14 + [_i] * 9 + [_p], _i),
        "contig_mq_parts": ([_i] + [_p] * 12 + [_i] * 8 + [_p], _i),
        "contig_mq_mma_parts": ([_p] * 13 + [_i] * 7 + [_p], _i),
    },
    "int4_matmul": {
        "int4_error_string": ([_i], ctypes.c_char_p),
        "int4_matmul": ([_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p], _i),
        "int4_matmul_i32": ([_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p], _i),
        "w4a8_matmul": ([_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p], _i),
    },
}
# The entry point that names a cudaError_t, per library.
_ERROR_STRING = {
    "attention": "attn_error_string",
    "paged_attention": "paged_error_string",
    "int4_matmul": "int4_error_string",
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ]
    for c in candidates:
        if c is not None and c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str = "attention") -> Path:
    """The library of source ``csrc/<name>.cu``; its digest covers the
    source and every shared header."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Sequence[str]] = None) -> str:
    """Compile the sources whose library does not exist yet, one ``nvcc``
    each, all started together; returns their output (``-Xptxas=-v``:
    registers, shared memory, spills), empty where nothing was built.
    Raises if any compilation fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs: Dict[str, "tuple[subprocess.Popen, str]"] = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            jobs[name] = (proc, tmp)
        logs, failures = [], []
        for name, (proc, tmp) in jobs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}) on {SOURCES[name]}:\n{err}")
                continue
            os.replace(tmp, library_path(name))  # atomic: a reader never sees half a file
            logs.append(out + err)
        if failures:
            raise RuntimeError("\n".join(failures))
        return "".join(logs)
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def library(name: str = "attention") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(err: int, name: str, lib: str = "attention") -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = getattr(library(lib), _ERROR_STRING[lib])(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")


# Per-device int32 tickets of the one-launch kernels (B2-B11), zero between
# launches: the last block of a group (the splits of a (row, kv head) or
# of a (q-tile, row, kv head), or of a column tile) to finish takes the
# group's ticket, merges and resets it. One buffer serves every launch of
# the current stream (launches on one stream never overlap).
_TICKETS: "dict[torch.device, torch.Tensor]" = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets on ``device``, shared by every
    one-launch kernel there."""
    buf = _TICKETS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = buf
    return buf
