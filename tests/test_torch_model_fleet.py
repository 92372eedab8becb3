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

Left out: ``test_model_mix_draws_seeded_and_summary_splits``, which
imports ``scripts/poisson_load.py``, whose port is ROADMAP item 18."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
)
LEFT_OUT = ("test_model_mix_draws_seeded_and_summary_splits",)
CASES = load_cases(globals(), "test_model_fleet.py", renames=RENAMES, leave_out=LEFT_OUT)


def test_every_model_fleet_case_is_loaded():
    assert len(CASES) == 13


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
