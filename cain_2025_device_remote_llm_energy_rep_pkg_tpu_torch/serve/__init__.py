"""HTTP serving layer — the framework's own equivalent of the reference's L8.

The reference delegates generation to an external Ollama server reached via
``curl POST http://<host>:11434/api/generate`` (experiment/RunnerConfig.py:
128-131; README.md:29-31). So far the port has the wire protocol
(``protocol.py``) and its client, ``RemoteHTTPBackend`` (``client.py``),
which the study's ``remote`` treatment uses when a server URL is given.
The server, the schedulers and the fleet are not ported yet.
"""

from .client import RemoteHTTPBackend
from .protocol import DEFAULT_PORT

__all__ = ["RemoteHTTPBackend", "DEFAULT_PORT"]
