"""The port's ``parallel/pp.py`` against the JAX package's on the CPU.

Twins of ``tests/test_pp.py``'s cases and of
``tests/test_moe.py::test_pp_loss_matches_single_device_moe``: the GPipe
schedule's loss and gradients over meshes of repeated CPU devices against
``jax.value_and_grad`` of the JAX ``next_token_loss`` (f32 zero caches) on
the same bridged params and tokens, the train step, the indivisible-layer
error, and ``pp_param_specs`` against the JAX PartitionSpecs. The JAX
references are computed once per model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import (
    get_model_config as jax_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import (
    Transformer as JaxTransformer,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel.pp import pp_param_specs as jax_pp_specs
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel.train import (
    next_token_loss as jax_next_token_loss,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.pp import (
    make_pp_grad,
    make_pp_loss,
    make_pp_train_step,
    pp_param_specs,
)
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

LOSS_RTOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3


def _moe(get):
    # tests/test_moe.py's _tiny_moe(n_layers=2)
    return dataclasses.replace(get("mixtral:8x7b").tiny(), n_experts=4, top_k_experts=2, n_layers=2)


# model -> (config of either package, batch, seq, params seed, tokens seed)
SETUPS = {
    "mistral:7b": (lambda get: dataclasses.replace(get("mistral:7b").tiny(), n_layers=4), 4, 12, 0, 1),
    "gemma:2b": (lambda get: dataclasses.replace(get("gemma:2b").tiny(), n_layers=4), 4, 12, 0, 1),
    "qwen2:1.5b": (lambda get: dataclasses.replace(get("qwen2:1.5b").tiny(), n_layers=4), 4, 12, 0, 1),
    "moe": (_moe, 4, 10, 0, 6),
}
GRAD_MODELS = ("mistral:7b", "qwen2:1.5b")  # the others compare the loss only


def _mesh(pp):
    return build_mesh(MeshSpec(axes=(("pp", pp),)), ["cpu"] * pp)


@pytest.fixture(scope="module")
def refs():
    """Per model, lazily: the JAX params (numpy), tokens and the
    unpipelined loss and gradients with f32 zero caches (test_pp.py's
    ``_reference_loss_and_grads``)."""
    cache = {}

    def get(model):
        if model not in cache:
            make, batch, seq, seed, tok_seed = SETUPS[model]
            jcfg = make(jax_config)
            params = JaxTransformer.initialise(jcfg, seed=seed, dtype=jnp.float32).params
            tokens = jax.random.randint(jax.random.PRNGKey(tok_seed), (batch, seq), 0, jcfg.vocab_size)
            shape = (jcfg.n_layers, batch, jcfg.n_kv_heads, seq - 1, jcfg.d_head)

            def loss_fn(p):
                zeros = jnp.zeros(shape, jnp.float32)
                return jax_next_token_loss(p, jcfg, tokens, zeros, zeros)

            if model in GRAD_MODELS:
                loss, grads = jax.value_and_grad(loss_fn)(params)
            else:
                loss, grads = jax.jit(loss_fn)(params), None
            cache[model] = {
                "jcfg": jcfg, "cfg": make(get_model_config), "np_params": jax.tree.map(np.asarray, params),
                "tokens": np.asarray(tokens), "loss": float(loss),
                "grads": None if grads is None else jax.tree.map(np.asarray, grads),
            }
        return cache[model]

    return get


def _params(ref):
    return params_from_numpy(ref["np_params"])


@pytest.mark.parametrize("pp,m", [(2, 2), (4, 4), (4, 2)])
def test_pp_loss_matches_single_device(refs, pp, m):
    ref = refs("mistral:7b")
    pp_loss = make_pp_loss(ref["cfg"], _mesh(pp), n_microbatches=m)
    np.testing.assert_allclose(float(pp_loss(_params(ref), ref["tokens"])), ref["loss"], rtol=LOSS_RTOL)


# gemma:2b exercises every architecture quirk the pipelined path must share
# with the single-device path: tied embeddings, sqrt(d) embed scaling,
# (1+w) gemma norms, and the gelu MLP.
def test_pp_loss_matches_single_device_gemma(refs):
    ref = refs("gemma:2b")
    pp_loss = make_pp_loss(ref["cfg"], _mesh(2), n_microbatches=2)
    np.testing.assert_allclose(float(pp_loss(_params(ref), ref["tokens"])), ref["loss"], rtol=LOSS_RTOL)


def test_pp_loss_matches_single_device_moe(refs):
    """The schedule shares run_blocks, so MoE layers pipeline too."""
    ref = refs("moe")
    pp_loss = make_pp_loss(ref["cfg"], _mesh(2), n_microbatches=2)
    np.testing.assert_allclose(float(pp_loss(_params(ref), ref["tokens"])), ref["loss"], rtol=LOSS_RTOL)


def test_pp_grads_match_single_device(refs):
    ref = refs("mistral:7b")
    params = _params(ref)
    loss, grads = make_pp_grad(ref["cfg"], _mesh(4), n_microbatches=2)(params, ref["tokens"])
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL)
    assert set(grads) == set(params)
    for name in params:
        np.testing.assert_allclose(
            grads[name].numpy(), ref["grads"][name], atol=GRAD_ATOL, rtol=GRAD_RTOL,
            err_msg=f"grad mismatch for {name}",
        )
        assert params[name].grad is None  # the caller's leaves are left as they were


def test_pp_train_step_decreases_loss_and_keeps_sharding(refs):
    ref = refs("qwen2:1.5b")
    cfg = ref["cfg"]
    mesh = _mesh(4)
    init_fn, step = make_pp_train_step(cfg, mesh, n_microbatches=2, learning_rate=1e-2)
    stages, opt_state = init_fn(_params(ref))

    def is_stage_sharded(stages):
        per = cfg.n_layers // 4
        return all(
            st["wq"].shape[0] == per and st["wq"].device == mesh.device_at(pp=i) for i, st in enumerate(stages)
        )

    assert is_stage_sharded(stages)
    losses = []
    for _ in range(3):
        stages, opt_state, loss = step(stages, opt_state, ref["tokens"])
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert is_stage_sharded(stages)
    # the replicated leaves' copies took one update
    for st in stages[1:]:
        assert torch.equal(st["embed"], stages[0]["embed"])
        assert st["embed"].data_ptr() != stages[0]["embed"].data_ptr()


def test_pp_train_step_first_loss_matches_single_device(refs):
    """The step's first loss is the unpipelined loss (qwen2's biases and
    tied head through the schedule); its gradients reach every stage."""
    ref = refs("qwen2:1.5b")
    init_fn, step = make_pp_train_step(ref["cfg"], _mesh(2), n_microbatches=4)
    stages, opt_state = init_fn(_params(ref))
    _, _, loss = step(stages, opt_state, ref["tokens"])
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL)
    for name in ("wq", "bq", "w_down"):
        grad = torch.cat([g[0].grad for g in opt_state.groups if any(g[0] is st[name] for st in stages)])
        np.testing.assert_allclose(grad.numpy(), ref["grads"][name], atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_pp_rejects_indivisible_layers(refs):
    cfg = refs("mistral:7b")["cfg"]
    with pytest.raises(ValueError, match="not divisible"):
        make_pp_loss(cfg, _mesh(3), n_microbatches=2)


@pytest.mark.parametrize("model", ["mistral:7b", "gemma:2b", "qwen2:1.5b", "moe"])
def test_pp_param_specs_match_jax(model):
    make = SETUPS[model][0]
    want = jax_pp_specs(make(jax_config))
    got = pp_param_specs(make(get_model_config))
    assert set(got) == set(want)
    for name, spec in want.items():
        assert got[name] == tuple(spec) + (None,) * (len(got[name]) - len(spec)), name
