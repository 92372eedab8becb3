"""The port's replica router and multi-model fleet against the JAX
package's, on the same requests over the same bridged tiny weights at
f32 (``models/bridge.py::params_from_numpy``).

Two routers, each over two ``LocalReplica``s: the JAX ``Router`` over
``JaxEngine`` replicas and the port's ``Router`` over
``TorchEngine(device="cpu")`` replicas, every engine on the paged pool.
Under ``round-robin`` and under ``roles=prefill,decode`` (the prefill
replica primes, the router seats the row on the decode replica, whose
session an anchor row holds open: both engines seat a migrated row only
into an open session) each request's greedy tokens, the replica it was
served on and whether it was migrated are the same on both sides, and
equal to one engine's solo ``generate``.

Then a two-model ``ModelFleetScheduler`` (tiny-a, and tiny-b with one
layer more) under ``small-first`` on each side: the same ``auto``
requests make the same escalation decisions (a capped answer cut at its
budget after at least ``escalate_max_tokens`` tokens escalates to
tiny-b, a shorter cap does not) and give the same tokens, and each
escalation charges ``cause="escalation"`` on both sides."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu import obs as jax_obs
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.obs import energy as jax_energy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.serve import model_fleet as jax_fleet
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.serve import router as jax_router
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch import obs as port_obs
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs import energy as port_energy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve import model_fleet as port_fleet
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve import router as port_router
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

MAX_SEQ = 1024
ANCHOR_TOKENS = 600
SIDES = ("jax", "port")


def _tiny(config_fn, name="tiny", extra_layers=0):
    cfg = config_fn("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=MAX_SEQ)
    return dataclasses.replace(cfg, name=name, n_layers=cfg.n_layers + extra_layers)


MODELS = {"tiny": 0, "tiny-a": 0, "tiny-b": 1}  # name -> layers over .tiny()'s


@pytest.fixture(autouse=True, scope="module")
def telemetry_on():
    was = [o.enabled() for o in (jax_obs, port_obs)]
    for o in (jax_obs, port_obs):
        o.enable()
    yield
    for o, on in zip((jax_obs, port_obs), was):
        (o.enable if on else o.disable)()


@pytest.fixture(scope="module")
def np_params():
    out = {}
    for i, (name, extra) in enumerate(MODELS.items()):
        params = init_params(_tiny(get_model_config, name, extra), jax.random.PRNGKey(11 + i), jnp.float32)
        out[name] = jax.tree.map(np.asarray, params)
    return out


def _engine(side, np_params, names):
    """One engine of ``side`` holding ``names``, on the paged pool."""
    if side == "jax":
        eng = JaxEngine(registry={}, dtype=jnp.float32, paged_kv=True)
        for n in names:
            eng.install_model(n, _tiny(get_model_config, n, MODELS[n]), jax.tree.map(jnp.asarray, np_params[n]))
    else:
        eng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", paged_kv=True)
        for n in names:
            eng.install_model(n, _tiny(port_config, n, MODELS[n]), params_from_numpy(np_params[n], "cpu", torch.float32))
    return eng


def _request(side, *args, **kw):
    return (JaxRequest if side == "jax" else GenerationRequest)(*args, **kw)


def _collect(chunks):
    toks, final = [], None
    for ch in chunks:
        if ch.done:
            final = ch.result
        else:
            toks.extend(ch.tokens)
    return toks, final


# (prompt, max_new_tokens): greedy, run past EOS, every prompt unique
ROWS = [
    ("the first routed request", 12),
    ("a second, somewhat longer routed request", 9),
    ("third", 14),
    ("the fourth request of the parity run", 10),
]


def _route(side, np_params, fleet_kind):
    """Serve ``ROWS`` one after another through ``side``'s router over two
    replicas; returns [(tokens, replica, migrated)] and the solo tokens."""
    mod = jax_router if side == "jax" else port_router
    roles = ("prefill", "decode") if fleet_kind == "disagg" else ("mixed", "mixed")
    replicas = [
        mod.LocalReplica(f"r{i}", _engine(side, np_params, ["tiny"]), role=role, max_batch=4)
        for i, role in enumerate(roles)
    ]
    router = mod.Router(replicas, policy="round-robin", probe_interval_s=999)
    anchors, stop = [], threading.Event()

    def hold_decode_session():
        """Anchor rows on the decode replica, a new one joining whenever
        fewer than two are live, so that its session never closes: the
        open session a seated row joins."""
        sched = replicas[1].scheduler
        while not stop.is_set():
            if (sched.health_state().get("inflight_rows") or 0) + sched.health_state()["queue_depth"] < 2:
                anchors.append(sched.submit_stream(_request(
                    side, "tiny", f"the decode replica's anchor {len(anchors)}", ANCHOR_TOKENS,
                    stop_at_eos=False, seed=1,
                )))
            time.sleep(0.005)

    keeper = threading.Thread(target=hold_decode_session, daemon=True)
    try:
        if fleet_kind == "disagg":
            keeper.start()
            deadline = time.monotonic() + 60
            while not replicas[1].scheduler.health_state().get("inflight_rows"):
                assert time.monotonic() < deadline, "the anchor never opened a session"
                time.sleep(0.02)
        out = []
        for prompt, n in ROWS:
            toks, final = _collect(
                router.dispatch_stream(_request(side, "tiny", prompt, n, stop_at_eos=False, seed=3))
            )
            assert final.tokens == toks
            out.append((toks, final.extras["router"]["replica"],
                        bool((final.extras.get("sched") or {}).get("migrated"))))
        solo_engine = replicas[0].backend
    finally:
        stop.set()
        if keeper.is_alive():
            keeper.join(timeout=10)
        for anchor in anchors:
            anchor.cancel(cause="disconnect")
        router.stop()
    solo = [solo_engine.generate(_request(side, "tiny", p, n, stop_at_eos=False, seed=3)).tokens for p, n in ROWS]
    return out, solo


@pytest.mark.parametrize("fleet_kind", ["round-robin", "disagg"])
def test_routers_serve_the_same_tokens_on_the_same_replicas(np_params, fleet_kind):
    got = {side: _route(side, np_params, fleet_kind) for side in SIDES}
    (jax_rows, jax_solo), (port_rows, port_solo) = got["jax"], got["port"]
    assert port_rows == jax_rows
    assert port_solo == jax_solo
    assert [r[0] for r in port_rows] == port_solo
    if fleet_kind == "disagg":
        assert [r[1:] for r in port_rows] == [("r1", True)] * len(ROWS)
    else:
        assert [r[1:] for r in port_rows] == [("r0", False), ("r1", False)] * (len(ROWS) // 2)


# (prompt, max_new_tokens): escalate_max_tokens is 6, so the 8-token caps
# escalate when cut at their budget and the 4-token cap never does
AUTO_ROWS = [("an auto request", 8), ("a short auto request", 4), ("another auto request", 8)]


def _fleet_run(side, np_params):
    mod = jax_fleet if side == "jax" else port_fleet
    energy = jax_energy if side == "jax" else port_energy
    engine = _engine(side, np_params, ["tiny-a", "tiny-b"])
    fleet = mod.ModelFleetScheduler(
        engine, models=["tiny-a", "tiny-b"], model_policy="small-first", escalate_max_tokens=6, max_batch=4
    )
    fleet.start()
    out = []
    try:
        assert fleet.models_by_size() == ["tiny-a", "tiny-b"]
        for prompt, n in AUTO_ROWS:
            j0 = energy.WASTED_J.labels(cause="escalation").value
            result = fleet.submit(_request(side, "auto", prompt, n, seed=4))
            charged = energy.WASTED_J.labels(cause="escalation").value - j0
            fleet_extras = result.extras["fleet"]
            out.append((result.tokens, result.request.model, bool(fleet_extras.get("escalated")), charged > 0))
    finally:
        fleet.stop()
    solo = {
        (p, m): engine.generate(_request(side, m, p, n, seed=4)).tokens
        for p, n in AUTO_ROWS for m in ("tiny-a", "tiny-b")
    }
    return out, solo


def test_small_first_fleets_make_the_same_escalations(np_params):
    (jax_rows, _), (port_rows, port_solo) = (_fleet_run(side, np_params) for side in SIDES)
    assert port_rows == jax_rows
    escalated = [row[2] for row in port_rows]
    assert escalated[1] is False and any(escalated)
    for (prompt, n), (toks, model, was_escalated, charged) in zip(AUTO_ROWS, port_rows):
        assert model == ("tiny-b" if was_escalated else "tiny-a")
        assert charged == was_escalated
        assert toks == port_solo[(prompt, model)]
