"""HTTP serving layer — the framework's own equivalent of the reference's L8.

The reference delegates generation to an external Ollama server reached via
``curl POST http://<host>:11434/api/generate`` (experiment/RunnerConfig.py:
128-131; README.md:29-31). ``GenerationServer`` (``server.py``) exposes the
same wire protocol (``protocol.py``) backed by any
:class:`~..engine.backend.GenerationBackend` (``TorchEngine`` on the card,
or the fake), serially or through the window and continuous schedulers
(``scheduler.py``, ``stream.py``); ``RemoteHTTPBackend`` (``client.py``)
is the client side, so the study's treatments fetch over a real HTTP
boundary exactly as the reference's did. The router, the multi-model
fleet and live row migration are not ported yet.
"""

from .client import RemoteHTTPBackend
from .protocol import DEFAULT_PORT
from .server import GenerationServer

__all__ = ["GenerationServer", "RemoteHTTPBackend", "DEFAULT_PORT"]
