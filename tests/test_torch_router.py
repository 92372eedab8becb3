"""The JAX package's ``tests/test_router.py`` on the port's
``serve/router.py``, loaded with the package name swapped: every case of
the replica router over the port's fake backend, schedulers, server and
client — membership and probing, each dispatch policy, the retry-once
rule (buffered and before the first streamed token), the terminal error
after it, drain and scale-up, the front door's ``/api/generate`` (SSE
included), ``/healthz``, ``/metrics`` and ``/debug/state``, and the
``RemoteReplica`` path over real ``serve`` sockets."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

CASES = load_cases(globals(), "test_router.py")


def test_every_router_case_is_loaded():
    assert len(CASES) == 32
