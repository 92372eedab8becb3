"""The port's ``parallel/`` against the JAX package's on the CPU.

The cases of ``tests/test_parallel.py`` other than training and the
roofline: mesh resolution (the port's ``MeshSpec`` resolves as the JAX
one does), the port's own head-aligned leaf rule (pinned here; where
heads align its specs are the JAX package's), ``shard_model`` (the shards
put back together give the leaves, any leaf form, bit for bit; int4
halves and i32 leaves sliced by rows and columns dequantize to the whole
leaf's slice), the sharded engine's tokens (``generate``,
``generate_batch``, ``generate_stream`` and ``generate_speculative`` on
meshes of 2 and 8 CPU shards, f32 weights and an int8 cache, equal to the
JAX ``TensorParallelEngine``'s on the same weights over 2 and 8 virtual
devices and to the port's unsharded engine; int8, int4 and int4-i32
weights equal to the unsharded engine), the stacked paged parts path, and
ring attention (against the JAX ring and causal attention).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import (
    get_model_config as jax_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel import mesh as jmesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel import sharding as jsharding
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel.ring import make_ring_attention as jax_ring
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel.tp import (
    TensorParallelEngine as JaxTP,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import quantize as tquant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops.attention import prefill_attention
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.ring import make_ring_attention
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.sharding import (
    param_specs,
    plan_for,
    shard_model,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.tp import TensorParallelEngine
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _tiny8(get=get_model_config, **overrides):
    """A tiny config whose head/ff dims divide tp ∈ {2, 8} (the
    test_parallel.py convention)."""
    return dataclasses.replace(
        get("mistral:7b").tiny(), n_heads=8, n_kv_heads=8, d_ff=128, d_model=64,
        d_head=16, max_seq_len=1024, **overrides,
    )


def _cpu_mesh(spec, n):
    return build_mesh(spec, ["cpu"] * n)


# -- meshes ------------------------------------------------------------------


@pytest.mark.parametrize(
    "axes,n",
    [
        ((("tp", -1),), 8), ((("dp", 2), ("tp", 4)), 8), ((("dp", 2), ("tp", -1)), 8),
        ((("tp", 2), ("ep", 4)), 8), ((("dp", 3), ("tp", 4)), 8),
        ((("dp", -1), ("tp", -1)), 8), ((("tp", 2),), 1), ((("tp", -1),), 0),
    ],
)
def test_mesh_spec_resolution(axes, n):
    """The port's MeshSpec resolves (or refuses) as the JAX one does."""
    try:
        want = jmesh.MeshSpec(axes=axes).resolve(n)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            MeshSpec(axes=axes).resolve(n)
        assert str(got.value) == str(exc)
        return
    assert MeshSpec(axes=axes).resolve(n) == want


def test_build_mesh_shape():
    """An explicit device list, one device named more than once (how one
    card holds several shards); without one, the visible GPUs (none on
    this host, so a mesh of 2 is refused with resolve's message)."""
    mesh = build_mesh(MeshSpec.dp_tp(2, 4), ["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")}
    assert mesh.device_at(dp=1, tp=3) == mesh.devices[7]
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        build_mesh(MeshSpec.tp_only(2))


# -- the leaf rule -------------------------------------------------------------

# (model, tp) -> (attn_tp, hq, hkv, kv_sharded, kv heads a shard reads)
RULES = {
    ("tiny8", 8): (8, 1, 1, True, [(t, t + 1) for t in range(8)]),
    ("qwen2:1.5b", 2): (2, 6, 1, True, [(0, 1), (1, 2)]),
    ("qwen2:1.5b", 4): (4, 3, 1, False, [(0, 1), (0, 1), (1, 2), (1, 2)]),
    ("qwen2:1.5b", 8): (1, 12, 2, False, [(0, 2)]),
    ("mixtral:8x7b", 2): (2, 16, 4, True, [(0, 4), (4, 8)]),
    ("gemma:2b", 2): (2, 4, 1, False, [(0, 1), (0, 1)]),
    ("odd", 2): (1, 6, 3, False, [(0, 3)]),
}


@pytest.mark.parametrize("model,tp", list(RULES))
def test_head_aligned_leaf_rule(model, tp):
    """The port's rule, pinned: attention shards whole heads where Hq
    divides tp; K/V shard where Hkv does, else each shard keeps a copy of
    the one KV head its query heads read, else attention stays whole."""
    cfg = {
        "tiny8": _tiny8(),
        "odd": dataclasses.replace(_tiny8(), n_heads=6, n_kv_heads=3),
    }.get(model) or get_model_config(model)
    plan = plan_for(cfg, _cpu_mesh(MeshSpec.tp_only(tp), tp))
    attn_tp, hq, hkv, kv_sharded, kv_heads = RULES[(model, tp)]
    assert (plan.attn_tp, plan.hq, plan.hkv, plan.kv_sharded) == (attn_tp, hq, hkv, kv_sharded)
    assert [plan.kv_heads(t) for t in range(plan.attn_tp)] == kv_heads
    assert plan.shard_cfg.n_heads == hq and plan.shard_cfg.n_kv_heads == hkv


def _jax_spec(spec, n):
    return tuple(list(spec) + [None] * (n - len(spec)))


@pytest.mark.parametrize("tp", [2, 8])
def test_param_specs_follow_divisibility(tp):
    """Where heads align the port's specs are the JAX package's; for
    qwen2:1.5b at tp 8 (Hq 12) the JAX package cuts wk/wv into quarter
    heads and the port keeps attention whole."""
    for cfg, jcfg in ((_tiny8(), _tiny8(jax_config)),):
        got = param_specs(cfg, _cpu_mesh(MeshSpec.tp_only(tp), tp))
        want = jsharding.param_specs(jcfg, jmesh.build_mesh(jmesh.MeshSpec.tp_only(), jax.devices()[:tp]))
        assert got == {k: _jax_spec(v, len(got[k])) for k, v in want.items()}
    qwen = param_specs(get_model_config("qwen2:1.5b"), _cpu_mesh(MeshSpec.tp_only(8), 8))
    jqwen = jsharding.param_specs(jax_config("qwen2:1.5b"), jmesh.build_mesh(jmesh.MeshSpec.tp_only()))
    assert tuple(jqwen["wk"]) == (None, None, "tp") and qwen["wk"] == (None, None, None)
    assert qwen["w_gate"] == (None, None, "tp") and qwen["embed"] == ("tp", None)


# -- shard_model -----------------------------------------------------------------


def _full(leaf):
    return tquant.maybe_dequant(leaf, torch.float32) if tquant.is_quantized(leaf) else leaf


@pytest.mark.parametrize("mode", [None, "int8", "int4", "int4-i32"])
@pytest.mark.parametrize("spec,n", [(MeshSpec.tp_only(2), 2), (MeshSpec.dp_tp(2, 4), 8)])
def test_shard_model_round_trip(mode, spec, n):
    """Each shard's leaves put back together along their cut axis give
    the whole leaf, dequantized bit for bit (int4 rows repacked); dp
    replicas on one device hold the same tensors."""
    cfg = _tiny8()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    if mode:
        params = tquant.quantize_params(params, mode=mode)
    mesh = _cpu_mesh(spec, n)
    trees = shard_model(params, cfg, mesh)
    plan = trees.plan
    cuts = {"wq": -1, "wk": -1, "wv": -1, "wo": -2, "w_gate": -1, "w_up": -1, "w_down": -2}
    for name, axis in cuts.items():
        group = trees.attn if name in ("wq", "wk", "wv", "wo") else {
            t: trees.mlp[(0, t, 0)] for t in range(plan.f_tp)
        }
        joined = torch.cat([_full(group[t][name]) for t in sorted(group)], dim=axis)
        assert torch.equal(joined, _full(params[name])), name
    embed = torch.cat([_full(trees.vocab[(0, t)]["embed"]) for t in range(plan.vocab_tp)])
    assert torch.equal(embed, _full(params["embed"]))
    if plan.dp > 1:
        assert trees.mlp[(1, 0, 0)]["w_up"] is not None
        a, b = trees.mlp[(0, 0, 0)]["w_down"], trees.mlp[(1, 0, 0)]["w_down"]
        assert all(x is y for x, y in zip(
            a.values() if isinstance(a, dict) else [a], b.values() if isinstance(b, dict) else [b]
        ))


@pytest.mark.parametrize("mode", ["int8", "int4", "int4-i32"])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("cut", [(0, 32), (32, 64), (8, 24), (4, 20)])
def test_quantized_leaf_slices_dequantize_to_the_slice(mode, axis, cut):
    """A row or column slice of a quantized leaf dequantizes to the same
    slice of the whole leaf, bit for bit: int4 halves repack their rows,
    i32 cuts lanes at multiples of 8 and repacks otherwise."""
    w = torch.randn((2, 64, 64), generator=torch.Generator().manual_seed(3))
    leaf = tquant.quantize_leaf("w_up", w, mode)
    start, stop = cut
    part = tquant.slice_leaf(leaf, axis, start, stop)
    whole = tquant.maybe_dequant(leaf, torch.float32)
    assert torch.equal(tquant.maybe_dequant(part, torch.float32), whole.narrow(axis, start, stop - start))
    if mode == "int4-i32" and axis == -2 and start % 8 == 0:
        assert torch.equal(part["q32"], leaf["q32"][:, start // 8 : stop // 8])


# -- the sharded engine --------------------------------------------------------

_JAX_ENGINES = {}


def _jax_tp(n, **kw):
    """A JAX TensorParallelEngine over n virtual devices with the tiny
    model and its one-layer draft loaded, and their params as numpy."""
    key = (n, tuple(sorted(kw.items())))
    if key not in _JAX_ENGINES:
        reg = {"tiny8": _tiny8(jax_config), "draft8": dataclasses.replace(_tiny8(jax_config), n_layers=1)}
        eng = JaxTP(
            mesh=jmesh.build_mesh(jmesh.MeshSpec.tp_only(), jax.devices()[:n]),
            registry=reg, dtype=jnp.float32, **kw,
        )
        for m in reg:
            eng.load_model(m)
        params = {m: jax.tree.map(np.asarray, eng._models[m].params) for m in reg}
        _JAX_ENGINES[key] = (eng, params)
    return _JAX_ENGINES[key]


def _port(np_params, n=None, **kw):
    reg = {"tiny8": _tiny8(), "draft8": dataclasses.replace(_tiny8(), n_layers=1)}
    if n is None:
        eng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", **kw)
    else:
        eng = TensorParallelEngine(
            mesh=_cpu_mesh(MeshSpec.tp_only(n), n), registry={}, dtype=torch.float32, **kw
        )
    for m, cfg in reg.items():
        eng.install_model(m, cfg, params_from_numpy(np_params[m], "cpu", torch.float32))
    return eng


ROWS = [
    ("tensor parallel", 12, {}),
    ("first sharded row", 10, {}),
    ("a second row that differs from the first", 12, dict(repeat_penalty=1.2)),
]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_tp_engine_matches_jax_tp_and_unsharded(n, kv):
    """generate, generate_batch (contiguous and paged), generate_stream
    and generate_speculative on the port's sharded engine all give the
    JAX TensorParallelEngine's generate tokens, and the port's unsharded
    engine's."""
    jeng, np_params = _jax_tp(n, kv_quantize=kv)
    want = [jeng.generate(JaxRequest("tiny8", p, m, stop_at_eos=False, **k)).tokens for p, m, k in ROWS]
    tp = _port(np_params, n, kv_quantize=kv)
    base = _port(np_params, None, kv_quantize=kv)
    reqs = [GenerationRequest("tiny8", p, m, stop_at_eos=False, **k) for p, m, k in ROWS]
    assert [tp.generate(r).tokens for r in reqs] == want
    assert [base.generate(r).tokens for r in reqs] == want
    assert [r.tokens for r in tp.generate_batch(reqs)] == want
    paged = _port(np_params, n, kv_quantize=kv, paged_kv=True)
    assert [r.tokens for r in paged.generate_batch(reqs)] == want
    chunks = list(tp.generate_stream(reqs[0], chunk_tokens=4))
    assert [t for c in chunks[:-1] for t in c.tokens] == want[0]
    assert chunks[-1].result.tokens == want[0]
    spec = tp.generate_speculative(reqs[0], "draft8", k=4)
    assert spec.tokens == want[0] and spec.extras["spec_rounds"] >= 1


@pytest.mark.parametrize("mode", ["int8", "int4", "int4-i32"])
def test_tp_quantized_weights_match_unsharded(mode):
    """Quantized weights cut per shard (int4 w_down and wo repacked by
    rows) give the unsharded engine's tokens, solo and batched."""
    _, np_params = _jax_tp(2)
    tp = _port(np_params, 2, quantize=mode)
    base = _port(np_params, None, quantize=mode)
    reqs = [GenerationRequest("tiny8", p, m, stop_at_eos=False, **k) for p, m, k in ROWS]
    want = [base.generate(r).tokens for r in reqs]
    assert [tp.generate(r).tokens for r in reqs] == want
    assert [r.tokens for r in tp.generate_batch(reqs)] == want


def test_tp_stacked_paged_parts_parity():
    """Sharded serving over the paged pool: each shard's heads go through
    the stacked per-layer parts path (its block of the folded pool), and
    every row (a sampled one included) equals the unsharded paged
    engine's; a write-through or whole-pool ``layer=`` leaf is refused
    with the JAX engine's reason."""
    _, np_params = _jax_tp(8)
    tp = _port(np_params, 8, paged_kv=True)
    base = _port(np_params, None, paged_kv=True)
    reqs = [
        GenerationRequest("tiny8", "stacked parts row one", 8),
        GenerationRequest("tiny8", "a somewhat longer second prompt for the paged pool", 14),
        GenerationRequest("tiny8", "sampled third row", 10, temperature=0.8, seed=7),
    ]
    got, want = tp.generate_batch(reqs), base.generate_batch(reqs)
    assert [(g.tokens, g.text) for g in got] == [(w.tokens, w.text) for w in want]
    tf = tp._models["tiny8"]
    assert tp._kv_dims(tf.cfg) == (2 * 8, 1)
    pool = torch.zeros((16, 4, 1, 128, 16))
    leaf = {"pool": pool, "table": torch.zeros((1, 1), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="per-layer stacked parts path only"):
        tf.params.forward(tf.cfg, torch.zeros((1, 1), dtype=torch.long), 0, leaf, leaf)


def test_ring_attention_matches_reference():
    """Ring attention over 8 sp shards equals causal attention and the
    JAX package's ring on the same inputs."""
    b, s, hq, hkv, d = 1, 64, 4, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv))
    ring = make_ring_attention(_cpu_mesh(MeshSpec(axes=(("sp", 8),)), 8))
    got = ring(*(torch.from_numpy(a) for a in (q, k, v)))
    ref = prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)
    jring = jax_ring(jmesh.build_mesh(jmesh.MeshSpec(axes=(("sp", 8),))))
    np.testing.assert_allclose(got.numpy(), np.asarray(jring(q, k, v)), atol=2e-5)


@pytest.mark.parametrize("gpus", [1, 2, 8])
def test_study_remote_runs_on_a_local_mesh_when_gpus_allow(gpus, monkeypatch, tmp_path):
    """With more than one visible GPU the study's ``remote`` runs on a
    local TensorParallelEngine over ``remote_tp`` of them (not aliased);
    on one card it stays the on-device engine, recorded as aliased."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments import llm_energy
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel import mesh, tp

    built = []
    monkeypatch.delenv("SERVER_IP", raising=False)
    monkeypatch.setattr(mesh, "visible_devices", lambda: [torch.device("cuda", i) for i in range(gpus)])
    monkeypatch.setattr(tp, "TensorParallelEngine", lambda **kw: built.append(kw) or object())
    cfg = llm_energy.LlmEnergyConfig(
        models=["qwen2:1.5b"], locations=["on_device", "remote"], lengths=[100],
        repetitions=1, results_output_path=tmp_path, remote_tp=2 if gpus == 8 else -1,
    )
    cfg._backends = {"on_device": object()}
    cfg._wire_remote_backend(allow_local_mesh=True)
    if gpus == 1:
        assert cfg._backends["remote"] is cfg._backends["on_device"] and cfg._remote_is_aliased()
        assert not built
        return
    (kw,) = built
    assert kw["quantize"] == "int8"
    assert kw["mesh"].shape == {"tp": 2 if gpus == 8 else gpus}
    assert not cfg._remote_is_aliased()
