"""Build + load the native sampler library.

Compiles ``sampler.cpp`` with g++ on first use into the package's
``_build/native/sampler-<hash>.so`` (hash of source + flags, so edits
rebuild automatically) and loads it with ctypes.
Returns None when no toolchain is available — callers fall back to the
Python samplers.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path
from typing import Optional

_NATIVE_DIR = Path(__file__).parent
_SOURCE = _NATIVE_DIR / "sampler.cpp"
_BUILD_DIR = _NATIVE_DIR.parent / "_build" / "native"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_cached: "Optional[ctypes.CDLL] | bool" = None  # None=untried, False=failed


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sampler_create.restype = ctypes.c_void_p
    lib.sampler_create.argtypes = [ctypes.c_long, ctypes.c_long, ctypes.c_char_p]
    lib.sampler_start.argtypes = [ctypes.c_void_p]
    lib.sampler_stop.argtypes = [ctypes.c_void_p]
    lib.sampler_count.restype = ctypes.c_long
    lib.sampler_count.argtypes = [ctypes.c_void_p]
    lib.sampler_read.restype = ctypes.c_long
    lib.sampler_read.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
    ]
    lib.sampler_has_rapl.restype = ctypes.c_int
    lib.sampler_has_rapl.argtypes = [ctypes.c_void_p]
    lib.sampler_destroy.argtypes = [ctypes.c_void_p]
    return lib


def load_sampler_library(rebuild: bool = False) -> Optional[ctypes.CDLL]:
    """Compile (cached) and load the sampler .so; None when unavailable."""
    global _cached
    if _cached is not None and not rebuild:
        return _cached or None

    source = _SOURCE.read_text()
    tag = hashlib.sha256((source + " ".join(_FLAGS)).encode()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"sampler-{tag}.so"
    try:
        if rebuild or not so_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", *_FLAGS, "-o", str(so_path), str(_SOURCE)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        _cached = _configure(ctypes.CDLL(str(so_path)))
    except (OSError, subprocess.SubprocessError) as exc:
        from ..runner import term

        term.log_warn(f"native sampler unavailable (falling back to Python): {exc}")
        _cached = False
        return None
    return _cached
