"""Native (C++) runtime components, built on demand with g++ and bound via
ctypes (no pybind11 needed). See ``build.py`` and ``sampler.cpp``."""

from .build import load_sampler_library

__all__ = ["load_sampler_library"]
