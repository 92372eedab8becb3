"""A row the JAX package exports seats in the port and finishes there.

A row preempted on ``JaxEngine`` (f32, the tiny qwen2) is exported by the
JAX package's ``serve/migrate.py::export_bundle``, sent through JSON,
imported by the port's ``import_bundle`` and seated into a port session
over the same params (``models/bridge.py::params_from_numpy``); its
tokens equal the JAX engine's solo ``generate``. On both contiguous
layouts (an f32 and an int8 cache) the slab seats as it is; on the JAX
package's unstacked paged layout (the CPU's, where the generated
positions live in the row's pages) the prompt pages stay pages and the
generated positions become side-cache columns of the port's stacked
layout. A sampled row's bundle carries a JAX PRNG key, which cannot
continue its stream in torch: its import is refused, naming the key."""

import json

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
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.serve.migrate import (
    export_bundle as jax_export_bundle,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.migrate import (
    MigrateRefused,
    import_bundle,
)
from test_torch_runner import one_torch_thread  # noqa: F401

LAYOUTS = {
    "contig-f32": dict(paged_kv=False),
    "contig-int8": dict(paged_kv=False, kv_quantize="int8"),
    "paged-f32": dict(paged_kv=True),
}


def _tiny(config_fn):
    return config_fn("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=512)


@pytest.fixture(scope="module")
def np_params():
    params = init_params(_tiny(get_model_config), jax.random.PRNGKey(7), jnp.float32)
    return jax.tree.map(np.asarray, params)


def _pair(np_params, **kw):
    port = TorchEngine(registry={}, dtype=torch.float32, device="cpu", **kw)
    port.install_model("tiny", _tiny(port_config), params_from_numpy(np_params, "cpu", torch.float32))
    jx = JaxEngine(registry={}, dtype=jnp.float32, **kw)
    jx.install_model("tiny", _tiny(get_model_config), jax.tree.map(jnp.asarray, np_params))
    return port, jx


ANCHOR = dict(prompt="source anchor decodes on", max_new_tokens=24, stop_at_eos=False)


def _jax_bundle(jx, victim):
    """Open a JAX session with an anchor and ``victim``, step, preempt the
    victim with swap and export it through JSON (the source settles its
    swap ledger)."""
    sess = jx.decode_open([JaxRequest("tiny", **ANCHOR), victim], reserve_rows=4)
    sess.step(4)
    pr = sess.preempt(victim, policy="swap")
    assert pr is not None
    bundle = json.loads(json.dumps(jax_export_bundle(pr, reason="disagg", streamed=0)))
    sess.resume_discard(pr)
    sess.close()
    return bundle


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_jax_bundle_seats_in_the_port_with_the_jax_solo_tokens(np_params, layout):
    port, jx = _pair(np_params, **LAYOUTS[layout])
    victim = JaxRequest("tiny", "the migrating row", max_new_tokens=20, stop_at_eos=False, seed=13)
    solo = jx.generate(victim).tokens
    bundle = _jax_bundle(jx, victim)
    assert bundle["kind"] == "real" and bundle["rng"]["dtype"] == "uint32"
    assert bundle["paged"] == LAYOUTS[layout]["paged_kv"] and not bundle["stacked"]
    pr = import_bundle(bundle)
    assert pr.gen_state is None  # a greedy row never draws

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest

    anchor = GenerationRequest("tiny", **ANCHOR)
    sess = port.decode_open([anchor], reserve_rows=4)
    sess.step(2)
    assert sess.can_resume(pr)
    pending = sess.resume_begin(pr, 64)
    while not sess.join_step(pending):
        pass
    sess.join_commit(pending)
    results = {}
    while sess.active:
        for res in sess.step(8):
            results[res.request.prompt] = res
    assert results[victim.prompt].tokens == solo
    assert results[anchor.prompt].tokens == jx.generate(JaxRequest("tiny", **ANCHOR)).tokens
    sess.close()
    if sess.paged:
        assert sess.pool.free_pages == sess.pool.n_pages - 1


@pytest.mark.parametrize("layout", ["contig-f32", "paged-f32"])
def test_a_sampled_jax_bundle_is_refused_naming_its_key(np_params, layout):
    _, jx = _pair(np_params, **LAYOUTS[layout])
    victim = JaxRequest(
        "tiny", "a sampled migrating row", max_new_tokens=20, stop_at_eos=False, seed=3,
        temperature=0.8,
    )
    bundle = _jax_bundle(jx, victim)
    with pytest.raises(MigrateRefused, match="JAX PRNG key"):
        import_bundle(bundle)
