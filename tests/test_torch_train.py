"""The port's ``parallel/train.py`` against the JAX package's on the CPU.

Backward through the port's forward with f32 and bf16 zero caches (the
plain path and ``ShardedParams.forward``) against ``jax.value_and_grad``
of the JAX ``next_token_loss``; the train step on one device and over a
dp 2 × tp 4 mesh of CPU shards against the JAX ``make_train_step`` (the
losses of 3 steps, the first step's gradients); ``remat`` against none;
the copies that the sharded tree holds (KV heads, dp replicas) staying
equal; and the twin of ``tests/test_parallel.py::
test_train_step_dp_tp_runs_and_learns``. The JAX references are computed
once per module.
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
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel import mesh as jmesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel.train import (
    make_train_step as jax_make_train_step,
    next_token_loss as jax_next_token_loss,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.sharding import shard_model
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.tp import ShardedParams
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.train import (
    copy_groups,
    gather_params,
    make_train_step,
    next_token_loss,
    value_and_grad,
    zero_caches,
)
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

# tests/test_pp.py's tolerances
LOSS_RTOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
BF16_STEP = 2.0**-8
STEP_LOSS_RTOL = 1e-4
STEPS = 3
# make_train_step's default. Adam's first steps move every element by
# about lr, whatever its gradient: at 1e-2 (or 1e-3) the near-zero bf16-cache
# gradients whose signs the two packages round apart move the second
# step's loss by 1.4e-4 relative.
LR = 1e-4
N_LAYERS = 4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(model="mistral:7b"):
    """The tiny config in both packages: mistral's grouping gives Hq 8,
    Hkv 2, so a tp-4 shard keeps a copy of the KV head its queries read."""
    return (dataclasses.replace(jax_config(model).tiny(), n_layers=N_LAYERS),
            dataclasses.replace(get_model_config(model).tiny(), n_layers=N_LAYERS))


def _cpu_mesh(spec, n):
    return build_mesh(spec, ["cpu"] * n)


@pytest.fixture(scope="module")
def ref():
    """JAX params and tokens, and everything the cases compare against:
    the loss and gradients of ``next_token_loss`` with f32 and bf16 zero
    caches, and the losses of 3 steps of the JAX ``make_train_step`` on one
    device (bf16 caches, remat)."""
    jcfg, cfg = _cfgs()
    np_params = jax.tree.map(np.asarray, JaxTransformer.initialise(jcfg, seed=0, dtype=jnp.float32).params)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(4, 17)).astype(np.int32)
    grads = {}
    for name, (jdt, _) in DTYPES.items():
        b, s = tokens.shape
        shape = (jcfg.n_layers, b, jcfg.n_kv_heads, s - 1, jcfg.d_head)

        def loss_fn(p, jdt=jdt, shape=shape):
            return jax_next_token_loss(p, jcfg, jnp.asarray(tokens), jnp.zeros(shape, jdt), jnp.zeros(shape, jdt))

        loss, g = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, np_params))
        grads[name] = (float(loss), jax.tree.map(np.asarray, g))
    mesh = jmesh.build_mesh(jmesh.MeshSpec.dp_tp(1, 1), jax.devices()[:1])
    init_fn, step = jax_make_train_step(jcfg, mesh, learning_rate=LR, remat=True)
    params, opt_state = init_fn(jax.tree.map(jnp.asarray, np_params))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return {"cfg": cfg, "np_params": np_params, "tokens": tokens, "grads": grads, "step_losses": losses}


def _params(ref):
    return params_from_numpy(ref["np_params"])


def _assert_grads(got, want, dtype="float32"):
    """test_pp.py's tolerance with f32 caches. A bf16 cache rounds K/V and
    their cotangents to bf16, and the two packages' f32 sums round apart
    before it, so there the absolute tolerance is one bf16 step (2^-8) of
    the leaf's largest gradient (the port is ~10x closer to the JAX
    package's bf16 gradients than those are to its f32 ones)."""
    assert set(got) == set(want)
    for name in want:
        atol = GRAD_ATOL if dtype == "float32" else max(GRAD_ATOL, BF16_STEP * float(np.abs(want[name]).max()))
        np.testing.assert_allclose(
            got[name].detach().numpy(), want[name], atol=atol, rtol=GRAD_RTOL,
            err_msg=f"grad mismatch for {name}",
        )


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_through_forward_matches_jax(ref, dtype):
    """The f32 case failed before the repair: attention saved the f32
    cache's view of one layer, which the next layer's in-place write bumped."""
    cfg, tokens = ref["cfg"], torch.as_tensor(ref["tokens"]).long()
    want_loss, want = ref["grads"][dtype]

    def loss_fn(p):
        k0, v0 = zero_caches(p, cfg, tokens.shape[0], tokens.shape[1] - 1, DTYPES[dtype][1])
        return next_token_loss(p, cfg, tokens, k0, v0)

    loss, grads = value_and_grad(loss_fn, _params(ref))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads(grads, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_through_sharded_forward_matches_jax(ref, dtype):
    """The same loss through ``ShardedParams.forward`` over tp 2 (each
    shard a KV head of its own), gathered back to the JAX layout."""
    cfg, tokens = ref["cfg"], torch.as_tensor(ref["tokens"]).long()
    want_loss, want = ref["grads"][dtype]
    mesh = _cpu_mesh(MeshSpec.tp_only(2), 2)
    trees = shard_model(_params(ref), cfg, mesh)
    for group in copy_groups(trees):
        for t in group:
            t.requires_grad_(True)
    sp = ShardedParams(trees, mesh)
    k0, v0 = zero_caches(sp, cfg, tokens.shape[0], tokens.shape[1] - 1, DTYPES[dtype][1])
    loss = next_token_loss(sp, cfg, tokens, k0, v0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_RTOL)
    _assert_grads(gather_params(sp, grads=True), want, dtype)


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 4)])
def test_train_step_matches_jax(ref, dp, tp):
    """3 steps on one batch: each loss within 1e-4 of the JAX step's, and
    the first step's gradients (bf16 caches) within ``_assert_grads``'s
    bf16 tolerance. Params after Adam are not compared element by element:
    where a gradient is near zero its sign, and so its update, can differ."""
    cfg = ref["cfg"]
    mesh = _cpu_mesh(MeshSpec.dp_tp(dp, tp), dp * tp)
    init_fn, step = make_train_step(cfg, mesh, learning_rate=LR, remat=True)
    params, opt_state = init_fn(_params(ref))
    losses = []
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state, ref["tokens"])
        losses.append(float(loss))
        if i == 0:
            _assert_grads(gather_params(params, grads=True), ref["grads"]["bfloat16"][1], "bfloat16")
    np.testing.assert_allclose(losses, ref["step_losses"], rtol=STEP_LOSS_RTOL)


def test_remat_matches_no_remat(ref):
    cfg = ref["cfg"]
    mesh = _cpu_mesh(MeshSpec.dp_tp(1, 1), 1)
    out = {}
    for remat in (True, False):
        init_fn, step = make_train_step(cfg, mesh, learning_rate=LR, remat=remat)
        params, opt_state = init_fn(_params(ref))
        params, opt_state, loss = step(params, opt_state, ref["tokens"])
        out[remat] = (float(loss), gather_params(params, grads=True))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for name, g in out[False][1].items():
        np.testing.assert_allclose(out[True][1][name].numpy(), g.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_copies_stay_equal_and_count_once(ref):
    """dp 2 × tp 4 over 8 CPU shards: the KV heads copied to two tp shards
    each and the FFN and vocabulary leaves of the dp replicas (each
    replica 1 tensor is replica 0's: one device) are one group apiece;
    the first step's gathered gradients equal the one-device step's, and
    after two steps every copy equals its group's first tensor."""
    cfg = ref["cfg"]
    mesh = _cpu_mesh(MeshSpec.dp_tp(2, 4), 8)
    init_fn, step = make_train_step(cfg, mesh, learning_rate=LR, remat=False)
    params, opt_state = init_fn(_params(ref))
    kv_groups = [g for g in opt_state.groups if len(g) > 1]
    assert len(kv_groups) == 4  # wk and wv: 2 KV heads, each held by 2 of the 4 shards
    assert params.trees.mlp[(1, 0, 0)]["w_up"] is params.trees.mlp[(0, 0, 0)]["w_up"]
    single_fn, single_step = make_train_step(cfg, _cpu_mesh(MeshSpec.dp_tp(1, 1), 1), learning_rate=LR,
                                             remat=False)
    single, single_state = single_fn(_params(ref))
    for i in range(2):
        params, opt_state, _ = step(params, opt_state, ref["tokens"])
        single, single_state, _ = single_step(single, single_state, ref["tokens"])
        if i == 0:  # a copy counted twice would double its gradient
            want = {k: v.numpy() for k, v in gather_params(single, grads=True).items()}
            _assert_grads(gather_params(params, grads=True), want, "bfloat16")
    for group in kv_groups:
        for t in group[1:]:
            assert torch.equal(t, group[0])


def test_gather_params_round_trips(ref):
    cfg = ref["cfg"]
    params = _params(ref)
    mesh = _cpu_mesh(MeshSpec.dp_tp(2, 4), 8)
    got = gather_params(ShardedParams(shard_model(params, cfg, mesh), mesh))
    assert set(got) == set(params)
    for name, leaf in params.items():
        assert torch.equal(got[name], leaf), name


def test_train_step_dp_tp_runs_and_learns():
    """Twin of tests/test_parallel.py::test_train_step_dp_tp_runs_and_learns."""
    cfg = dataclasses.replace(
        get_model_config("mistral:7b").tiny(), n_heads=8, n_kv_heads=8, d_ff=128, d_model=64, d_head=16
    )
    mesh = _cpu_mesh(MeshSpec.dp_tp(2, 4), 8)
    init_fn, step = make_train_step(cfg, mesh, learning_rate=1e-2, remat=True)
    params, opt_state = init_fn(init_params(cfg, torch.Generator().manual_seed(0), torch.float32))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(4, 33))
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # memorising a fixed batch: loss must drop
