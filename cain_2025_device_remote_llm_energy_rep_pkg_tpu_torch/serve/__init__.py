"""HTTP serving layer — the framework's own equivalent of the reference's L8.

The reference delegates generation to an external Ollama server reached via
``curl POST http://<host>:11434/api/generate`` (experiment/RunnerConfig.py:
128-131; README.md:29-31). ``GenerationServer`` (``server.py``) exposes the
same wire protocol (``protocol.py``) backed by any
:class:`~..engine.backend.GenerationBackend` (``TorchEngine`` on the card,
the tensor-parallel engine, or the fake), serially, through the window and
continuous schedulers (``scheduler.py``, ``stream.py``) or the multi-model
fleet (``model_fleet.py``); ``RemoteHTTPBackend`` (``client.py``) is the
client side, so the study's treatments fetch over a real HTTP boundary
exactly as the reference's did. ``Router`` / ``RouterServer``
(``router.py``) put replicas, in process (``LocalReplica``) or behind
their own servers (``RemoteReplica``), behind one front door.
"""

from .client import RemoteHTTPBackend
from .model_fleet import ModelFleetScheduler
from .protocol import DEFAULT_PORT
from .router import (
    LocalReplica,
    RemoteReplica,
    Router,
    RouterServer,
)
from .server import GenerationServer

__all__ = [
    "GenerationServer",
    "RemoteHTTPBackend",
    "DEFAULT_PORT",
    "ModelFleetScheduler",
    "Router",
    "RouterServer",
    "LocalReplica",
    "RemoteReplica",
]
