"""The JAX package's ``tests/test_model_fleet.py`` on the port's
``serve/model_fleet.py``, loaded with the package name swapped: one lane
per model, the KV budget split, ``model: "auto"`` under
``cheapest-joules`` and ``small-first`` (the escalation and its
``cause="escalation"`` charge), streamed auto, the refused
configurations, the router's placement preference, and the engine side
of the envelope (an eviction deferred until a live session drains, the
session pins) on ``TorchEngine(device="cpu")`` with two tiny models at
f32. Then the port's own case: a ``GenerationServer(model_policy=...)``
takes ``model: "auto"`` over HTTP (buffered and streamed) although its
``--models`` list does not name it, and answers with the fleet's
attribution.

``test_model_mix_draws_seeded_and_summary_splits`` imports the port's
``scripts/torch_poisson_load.py`` in place of ``scripts/poisson_load.py``.

Left out: ``test_no_cross_model_head_of_line_blocking``, which decides by
the wall clock (clients sleeping 0.08 s and 0.12 s against a 0.64 s fake
decode) and flips under a loaded host. The port's own
``test_small_lane_retires_while_big_row_decodes`` makes the same claim by
order: the small requests return while the big row is still live in its
lane."""

import threading
import time

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
    ("from poisson_load import", "from torch_poisson_load import"),
)
LEFT_OUT = ("test_no_cross_model_head_of_line_blocking",)
CASES = load_cases(globals(), "test_model_fleet.py", renames=RENAMES, leave_out=LEFT_OUT)


def test_every_model_fleet_case_is_loaded():
    assert len(CASES) == 13


def test_small_lane_retires_while_big_row_decodes():
    """A long big-model decode in flight does not delay small-model
    requests: both small requests return while the big row is still live
    in its lane. The big budget (4,096 tokens at 200 tokens/s, 20 s) is
    far past any small request's time, and the big row is ended by
    ``fleet.stop()``. The waits poll lane state and join threads; none
    takes the shared backend lock the lanes step under."""
    backend = FakeBackend(tokens_per_s=200.0, simulate_delay=True, model_bytes={SMALL: 100, BIG: 1000})
    _b, fleet = _fleet(backend)
    outcome = {}

    def client(name, model, n):
        try:
            outcome[name] = fleet.submit(_req(model, name, n=n))
        except Exception as exc:  # noqa: BLE001 — the big row ends at stop()
            outcome[name] = exc

    big = threading.Thread(target=client, args=("big", BIG, 4096), daemon=True)
    try:
        big.start()
        deadline = time.monotonic() + 30.0
        while not fleet._lanes[BIG].debug_state().get("inflight"):
            assert time.monotonic() < deadline, "the big row never went live"
            time.sleep(0.01)
        smalls = [threading.Thread(target=client, args=(name, SMALL, 8), daemon=True) for name in ("s1", "s2")]
        for t in smalls:
            t.start()
        for t in smalls:
            t.join(timeout=30.0)
            assert not t.is_alive(), "a small request waited on the big decode"
        assert [len(outcome[name].tokens) for name in ("s1", "s2")] == [8, 8]
        assert big.is_alive() and "big" not in outcome
        assert [row["model"] for row in fleet._lanes[BIG].debug_state()["inflight"]] == [BIG]
    finally:
        fleet.stop()
    big.join(timeout=30.0)
    assert not big.is_alive()


def test_fleet_server_takes_auto_over_http():
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import RemoteHTTPBackend
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.server import GenerationServer

    backend = FakeBackend(model_bytes={SMALL: 100, BIG: 1000}, model_joules={SMALL: 0.1, BIG: 0.9})
    server = GenerationServer(backend, host="127.0.0.1", port=0, models=[SMALL, BIG], quiet=True,
                              model_policy="small-first", escalate_max_tokens=32)
    server.start()
    try:
        assert server.scheduler_mode == "fleet"
        client = RemoteHTTPBackend(f"http://127.0.0.1:{server.port}")
        result = client.generate(_req(AUTO_MODEL, "route me", n=8))
        assert result.extras["fleet"] == {"model": SMALL, "policy": "small-first"}
        chunks = list(client.generate_stream(_req(AUTO_MODEL, "stream me", n=8)))
        assert chunks[-1].done and chunks[-1].result.tokens
        with pytest.raises(Exception, match="not found"):
            client.generate(_req("other:3b", "nobody serves this", n=4))
    finally:
        server.stop()
