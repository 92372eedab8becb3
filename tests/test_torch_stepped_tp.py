"""The port's sharded stepped sessions: ``tests/test_stepped_tp.py`` on the
port's ``TensorParallelEngine``.

The 17 cases of the JAX file, on meshes of 2 and 8 CPU shards (tp) and of
dp × tp shards, with the JAX file's tiny model (``_tiny8``): every row of
a session, mid-flight joiners, shared-prefix joiners and speculating rows
included, gives the tokens of its solo ``generate`` on the same sharded
engine, and in the parity matrices the JAX ``TensorParallelEngine``'s
tokens on the same (bridged) weights over as many virtual devices.
Cancellation restores the pool's free count exactly, and a dp session
keeps each row's pages in its shard's range and one parking page a shard.

Last, ``test_spec_sampled.py``'s mesh case: a sampled speculating session
on 2 and 8 shards keeps its per-row spec leaves in one copy, and its
sampled rows equal the unsharded engine's.

Where the JAX cases read the carry's ``NamedSharding`` specs, these read
the port's ownership rule (``sharding.carry_layout``: KV leaves by heads
over tp, rows over dp) and the folded shapes of the KV leaves, whose
leading axis is (shard, layer).
"""

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
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import (
    get_model_config as jax_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel import mesh as jmesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel.tp import (
    TensorParallelEngine as JaxTP,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.sharding import carry_layout
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.tp import TensorParallelEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.scheduler import ContinuousScheduler
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.stream import DeadlineExceeded
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _tiny8(get=get_model_config, **overrides):
    """A tiny config whose head/ff dims divide tp ∈ {2, 8} (the
    test_parallel.py convention)."""
    return dataclasses.replace(
        get("mistral:7b").tiny(), n_heads=8, n_kv_heads=8, d_ff=128, d_model=64,
        d_head=16, max_seq_len=1024, **overrides,
    )


_JAX = {}


def _jax_engine(dp, tp, **kw):
    """The JAX TensorParallelEngine over dp × tp virtual devices with
    ``tiny`` loaded, and its params as numpy (one a mesh and cache kind)."""
    key = (dp, tp, tuple(sorted(kw.items())))
    if key not in _JAX:
        spec = jmesh.MeshSpec.dp_tp(dp, tp) if dp > 1 else jmesh.MeshSpec.tp_only()
        eng = JaxTP(
            mesh=jmesh.build_mesh(spec, jax.devices()[: dp * tp]),
            registry={"tiny": _tiny8(jax_config)}, dtype=jnp.float32, **kw,
        )
        eng.load_model("tiny")
        _JAX[key] = (eng, jax.tree.map(np.asarray, eng._models["tiny"].params))
    return _JAX[key]


def _engine(dp, tp, registry=None, bridge=True, **kwargs):
    """The port's sharded engine over dp × tp CPU shards, with the JAX
    engine's ``tiny`` weights installed (``bridge``)."""
    spec = MeshSpec.dp_tp(dp, tp) if dp > 1 else MeshSpec.tp_only(tp)
    eng = TensorParallelEngine(
        mesh=build_mesh(spec, ["cpu"] * (dp * tp)),
        registry=dict(registry or {"tiny": _tiny8()}), dtype=torch.float32, **kwargs,
    )
    if bridge:
        _, params = _jax_engine(1, 2)
        eng.install_model("tiny", _tiny8(), params_from_numpy(params, "cpu", torch.float32))
    return eng


def _jax_tokens(dp, tp, reqs, **kw):
    """Each request's solo tokens on the JAX sharded engine (whose
    seeded init gives every mesh ``_engine``'s weights)."""
    jeng, _ = _jax_engine(dp, tp, **kw)
    out = []
    for r in reqs:
        jr = JaxRequest(
            r.model, r.prompt, r.max_new_tokens, seed=r.seed, stop_at_eos=r.stop_at_eos,
        )
        out.append(jeng.generate(jr).tokens)
    return out


def _drain(session, max_steps=8, limit=300):
    out = []
    for _ in range(limit):
        if not session.active:
            break
        out.extend(session.step(max_steps))
    assert not session.active, "session did not drain"
    return out


LAYOUTS = [
    pytest.param(False, None, id="contiguous-bf16"),
    pytest.param(False, "int8", id="contiguous-int8kv"),
    pytest.param(True, None, id="paged-bf16"),
    pytest.param(True, "int8", id="paged-int8kv"),
]


def _layouts(sess, draft_cfg=None):
    return carry_layout(sess.cfg, sess.engine.mesh, sess.carry, draft_cfg=draft_cfg, dp_shards=sess.dp_shards)


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("paged,kv", LAYOUTS)
def test_tp_stepped_parity_with_mid_flight_join(n_devices, paged, kv):
    """4 cache layouts × {2, 8} shards, a mid-flight joiner included:
    every row equals its solo generate() on the same sharded engine and
    the JAX TensorParallelEngine's on the same weights."""
    eng = _engine(1, n_devices, paged_kv=paged, kv_quantize=kv)
    anchor = GenerationRequest("tiny", "anchor runs long on the mesh", max_new_tokens=24, stop_at_eos=False)
    short = GenerationRequest("tiny", "short companion", max_new_tokens=6, seed=2)
    joiner = GenerationRequest("tiny", "late arrival joins mid-flight", max_new_tokens=10, seed=3)
    reqs = (anchor, short, joiner)
    solo = {id(r): eng.generate(r).tokens for r in reqs}
    assert [solo[id(r)] for r in reqs] == _jax_tokens(1, n_devices, reqs, paged_kv=paged, kv_quantize=kv)
    sess = eng.decode_open([anchor, short], reserve_rows=4)
    sess.step(4)  # anchor mid-flight
    assert sess.can_join(joiner)
    sess.join(joiner)
    results = {id(r.request): r for r in _drain(sess)}
    for req in reqs:
        assert results[id(req)].tokens == solo[id(req)], f"tp={n_devices} paged={paged} kv={kv}"
    sess.close()


def test_tp_carry_shardings_declared_and_stable():
    """KV leaves split their heads over tp (the pool folded [8·L, P, 1,
    page, D]), row-control leaves have one copy, a slice leaves the
    layout as it was, and each of the 8 shards holds 1/8 of the pool."""
    eng = _engine(1, 8, paged_kv=True)
    sess = eng.decode_open(
        [GenerationRequest("tiny", "sharding probe", max_new_tokens=20, stop_at_eos=False)],
        reserve_rows=2,
    )
    before = _layouts(sess)
    assert before["pool"] == {"heads": "tp", "rows": None}
    assert before["side_k"] == before["side_v"] == {"heads": "tp", "rows": None}
    for key in ("tokens", "done", "remaining", "table", "presence"):
        assert before[key] == {"heads": None, "rows": None}, key
    assert tuple(sess.pool.k.shape) == (8 * 2, sess.pool.n_pages, 1, 128, 16)
    sess.step(4)
    assert _layouts(sess) == before
    state = sess.debug_state()
    assert state["mesh"]["devices"] == 8
    assert state["mesh"]["axes"] == {"tp": 8}
    assert state["pool"]["per_device"]["bytes"] == sess.pool.payload_nbytes() // 8
    sess.close()


def test_tp_carry_falls_back_to_replicated_kv():
    """Heads that do not split over the mesh (Hq 6 on tp 2 would cut a
    GQA group) keep attention and the cache whole on one shard; the
    session stays correct through a join."""
    cfg = dataclasses.replace(_tiny8(), n_heads=6, n_kv_heads=3)
    eng = _engine(1, 2, registry={"tiny3": cfg}, bridge=False, paged_kv=True)
    req = GenerationRequest("tiny3", "odd heads", max_new_tokens=16, stop_at_eos=False)
    joiner = GenerationRequest("tiny3", "replicated joiner", max_new_tokens=6, seed=4)
    solo, solo_joiner = eng.generate(req), eng.generate(joiner)
    sess = eng.decode_open([req], reserve_rows=2)
    assert _layouts(sess)["pool"] == {"heads": None, "rows": None}
    assert tuple(sess.pool.k.shape)[::2] == (2, 3, 16)  # [L, P, 3, page, D]: no fold
    sess.step(4)
    sess.join(joiner)
    assert _layouts(sess)["pool"] == {"heads": None, "rows": None}
    results = {id(r.request): r for r in _drain(sess)}
    assert results[id(req)].tokens == solo.tokens
    assert results[id(joiner)].tokens == solo_joiner.tokens
    sess.close()


def test_tp_shared_prefix_joiner_parity_and_exact_restoration():
    """Shared-prefix pages on the mesh: the joiner maps the published
    prompt's pages (each shard's block of them) read-only, prefills only
    its tail, matches solo, and close() restores the free count."""
    eng = _engine(1, 8, paged_kv=True, prefix_share=True)
    prefix = "s" * 140 + " "
    anchor = GenerationRequest("tiny", prefix + "anchor question", max_new_tokens=24, stop_at_eos=False)
    sharer = GenerationRequest("tiny", prefix + "different tail", max_new_tokens=8, seed=5)
    solo_sharer = eng.generate(sharer)
    sess = eng.decode_open([anchor], reserve_rows=4)
    sess.step(2)
    assert sess.can_join(sharer)
    free_before_join = sess.pool.free_pages
    pj = sess.join_begin(sharer)
    assert pj.hit_tokens > 0, "joiner did not hit the published prefix"
    assert pj.shared_pages > 0, "no pool pages were mapped read-only"
    assert free_before_join - sess.pool.free_pages < len(pj.pages)
    while not sess.join_step(pj):
        pass
    sess.join_commit(pj)
    assert sess.pool.shared_pages > 0
    results = {id(r.request): r for r in _drain(sess)}
    assert results[id(sharer)].tokens == solo_sharer.tokens
    sess.close()
    assert sess.pool.free_pages == sess.pool.n_pages - 1


def _spec_engine(n_devices, **kwargs):
    draft_cfg = dataclasses.replace(_tiny8(), n_layers=1)
    return _engine(
        1, n_devices, registry={"tiny": _tiny8(), "tiny-d": draft_cfg}, paged_kv=True, **kwargs,
    )


@pytest.mark.parametrize("n_devices", [2, 8])
def test_tp_spec_session_parity_and_draft_sharding(n_devices):
    """A speculating session on the mesh: the draft's cache split by the
    DRAFT model's own heads (folded [tp·1, B, 8/tp, T, D]), per-row spec
    state in one copy, the layout stable over spec slices and a join, and
    every row the plain greedy stream."""
    eng = _spec_engine(n_devices, speculative={"tiny": ("tiny-d", 3)})
    anchor = GenerationRequest("tiny", "mesh anchor runs long", max_new_tokens=24, stop_at_eos=False)
    joiner = GenerationRequest("tiny", "late mesh arrival", max_new_tokens=10, seed=3)
    sess = eng.decode_open([anchor], reserve_rows=4)
    assert sess.spec is not None
    layout = _layouts(sess, sess.spec["dcfg"])
    assert layout["draft_k"] == {"heads": "tp", "rows": None}
    dk = sess.carry["draft_k"]
    assert tuple(dk.shape[:3]) == (n_devices, 4, 8 // n_devices)
    for key in ("draft_offsets", "spec_rounds", "spec_accepted"):
        if key in sess.carry:
            assert layout[key] == {"heads": None, "rows": None}, key
    before = {k: tuple(v.shape) for k, v in sess.carry.items() if isinstance(v, torch.Tensor)}
    sess.step(4)
    assert sess.can_join(joiner)
    sess.join(joiner)
    results = {id(r.request): r for r in _drain(sess)}
    after = {k: tuple(v.shape) for k, v in sess.carry.items() if isinstance(v, torch.Tensor)}
    assert after == before
    for req in (anchor, joiner):
        assert results[id(req)].tokens == eng._generate_plain(req).tokens, f"tp={n_devices}"
        assert results[id(req)].extras["spec"]["rounds"] >= 1
    sess.close()
    assert sess.pool.free_pages == sess.pool.n_pages - 1


@pytest.mark.parametrize("n_devices", [2, 8])
def test_tp_spec_stacked_native_verify_on_mesh(n_devices):
    """The stacked native verify on the mesh: each shard's multi-query
    parts path (B7/B8's plain versions here) over its block of the pool,
    the candidates in its block of the side caches; prompt-only pages;
    every row a plain engine's greedy stream."""
    eng = _spec_engine(n_devices, speculative={"tiny": ("tiny-d", 3)})
    exp = _spec_engine(n_devices)
    anchor = GenerationRequest("tiny", "stacked mesh anchor", max_new_tokens=20, stop_at_eos=False)
    joiner = GenerationRequest("tiny", "stacked mesh joiner", max_new_tokens=8, seed=3)
    sess = eng.decode_open([anchor], reserve_rows=4)
    assert sess.spec is not None and sess.stacked
    assert sess._pages_needed(100, 40) == -(-100 // 128)
    sess.step(2)
    assert sess.can_join(joiner)
    sess.join(joiner)
    results = {id(r.request): r for r in _drain(sess)}
    for req in (anchor, joiner):
        assert results[id(req)].tokens == exp._generate_plain(req).tokens
        assert results[id(req)].extras["spec"]["rounds"] >= 1
    sess.close()
    assert sess.pool.free_pages == sess.pool.n_pages - 1


def test_tp_cancel_restores_free_count_exactly():
    """cancel() on sharded rows parks the table row, frees the victim's
    pages (exact free count) and the anchor decodes on to its solo
    stream."""
    eng = _engine(1, 8, paged_kv=True)
    anchor = GenerationRequest("tiny", "anchor", max_new_tokens=40, stop_at_eos=False)
    victim = GenerationRequest("tiny", "victim row to cancel", max_new_tokens=40, stop_at_eos=False, seed=3)
    solo_anchor = eng.generate(anchor)
    sess = eng.decode_open([anchor], reserve_rows=4)
    free_before_join = sess.pool.free_pages
    sess.step(4)
    sess.join(victim)
    victim_pages = next(row.pages for row in sess.rows if row is not None and row.request is victim)
    assert sess.pool.free_pages == free_before_join - len(victim_pages)
    sess.step(4)
    assert sess.cancel(victim)
    assert sess.pool.free_pages == free_before_join
    assert sess.active == 1
    results = _drain(sess)
    assert results[0].tokens == solo_anchor.tokens
    sess.close()


# -- dp × tp row sharding ----------------------------------------------------------


@pytest.mark.parametrize("paged,kv", LAYOUTS)
def test_dp_stepped_parity_all_layouts(paged, kv):
    """dp 2 × tp 2, all four cache layouts: every row, a mid-flight joiner
    included, equals its solo generate() on the same engine and the JAX
    dp × tp engine's."""
    eng = _engine(2, 2, paged_kv=paged, kv_quantize=kv)
    anchor = GenerationRequest("tiny", "dp anchor runs long on the mesh", max_new_tokens=24, stop_at_eos=False)
    short = GenerationRequest("tiny", "dp short companion", max_new_tokens=6, seed=2)
    joiner = GenerationRequest("tiny", "dp late joiner lands here", max_new_tokens=10, seed=3)
    reqs = (anchor, short, joiner)
    solo = {id(r): eng.generate(r).tokens for r in reqs}
    assert [solo[id(r)] for r in reqs] == _jax_tokens(2, 2, reqs, paged_kv=paged, kv_quantize=kv)
    sess = eng.decode_open([anchor, short], reserve_rows=4)
    assert sess.dp_shards == 2, "dp never engaged on the 2x2 mesh"
    sess.step(4)
    assert sess.can_join(joiner)
    sess.join(joiner)
    results = {id(r.request): r for r in _drain(sess)}
    for req in reqs:
        assert results[id(req)].tokens == solo[id(req)], f"dp=2 tp=2 paged={paged} kv={kv}"
    sess.close()


@pytest.mark.parametrize("dp,tp", [(4, 1), (2, 4), (4, 2)])
def test_dp_mesh_shapes_paged_parity(dp, tp):
    """Pure dp (4×1), wide tp (2×4) and 4×2: the same session code takes
    whatever dp the mesh offers and stays solo-identical."""
    eng = _engine(dp, tp, paged_kv=True)
    reqs = [
        GenerationRequest("tiny", f"dp sweep row {i}", max_new_tokens=12, seed=i + 1, stop_at_eos=False)
        for i in range(3)
    ]
    solo = {id(r): eng.generate(r) for r in reqs}
    sess = eng.decode_open(reqs, reserve_rows=4)
    assert sess.dp_shards == dp
    results = {id(r.request): r for r in _drain(sess)}
    for req in reqs:
        assert results[id(req)].tokens == solo[id(req)].tokens, f"dp={dp} tp={tp}"
    sess.close()
    assert sess.pool.free_pages == sess.pool.n_pages - sess.dp_shards


def test_dp_carry_shardings_declared_and_stable():
    """Under dp the KV leaves split their rows (the pool its pages) over
    dp beside their heads over tp, the row-control leaves split their
    rows, and a slice leaves the layout as it was."""
    eng = _engine(2, 2, paged_kv=True)
    sess = eng.decode_open(
        [GenerationRequest("tiny", "dp sharding probe", max_new_tokens=20, stop_at_eos=False)],
        reserve_rows=4,
    )
    assert sess.dp_shards == 2
    before = _layouts(sess)
    assert before["pool"] == {"heads": "tp", "rows": "dp"}
    for key in ("tokens", "done", "remaining", "table"):
        assert before[key] == {"heads": None, "rows": "dp"}, key
    sess.step(4)
    assert _layouts(sess) == before
    state = sess.debug_state()
    assert state["mesh"]["devices"] == 4
    assert state["mesh"]["axes"] == {"dp": 2, "tp": 2}
    assert state["pool"]["dp_shards"] == 2
    assert state["pool"]["per_device"]["bytes"] == sess.pool.payload_nbytes() // 4
    sess.close()


def test_dp_per_shard_parking_and_page_locality():
    """One parking page a dp shard, and every row's pages in the range of
    the shard that owns its slot; cancel keeps the exact free count."""
    eng = _engine(2, 2, paged_kv=True)
    reqs = [GenerationRequest("tiny", f"locality row {i}", max_new_tokens=8, seed=i + 1) for i in range(4)]
    sess = eng.decode_open(reqs, reserve_rows=4)
    assert sess.dp_shards == 2
    assert len(sess.parking_pages) == 2
    half = sess.pool.n_pages // 2
    shard_of = lambda p: 0 if p < half else 1  # noqa: E731
    assert sorted(shard_of(p) for p in sess.parking_pages) == [0, 1]
    assert [sess.pool.shard_of(p) for p in sess.parking_pages] == [0, 1]
    for r, row in enumerate(sess.rows):
        if row is None:
            continue
        want = sess._row_shard(r)
        assert all(shard_of(p) == want for p in row.pages), (r, want, row.pages)
        assert all(p == sess.parking_pages[want] for p in sess.carry["table"][r, len(row.pages):].tolist())
    free_before = sess.pool.free_pages
    victim = next(row for row in sess.rows if row is not None)
    pages = len(victim.pages)
    assert sess.cancel(victim.request)
    assert sess.pool.free_pages == free_before + pages
    sess.close()


def test_dp_mid_flight_join_lands_on_row_shard():
    """A mid-flight joiner takes its pages in the range of the shard
    owning its slot, and matches solo."""
    eng = _engine(2, 2, paged_kv=True)
    anchor = GenerationRequest("tiny", "dp join anchor", max_new_tokens=20, stop_at_eos=False)
    joiner = GenerationRequest("tiny", "dp joiner lands sharded", max_new_tokens=8, seed=5)
    solo_joiner = eng.generate(joiner)
    sess = eng.decode_open([anchor], reserve_rows=4)
    assert sess.dp_shards == 2
    sess.step(2)
    sess.join(joiner)
    half = sess.pool.n_pages // 2
    r, row = next((r, row) for r, row in enumerate(sess.rows) if row is not None and row.request is joiner)
    want = sess._row_shard(r)
    assert all((0 if p < half else 1) == want for p in row.pages), (r, want, row.pages)
    results = {id(r_.request): r_ for r_ in _drain(sess)}
    assert results[id(joiner)].tokens == solo_joiner.tokens
    sess.close()


def test_dp_indivisible_bucket_falls_back_to_tp_only():
    """A bucket width that does not divide dp keeps the rows whole (one
    copy of the row-control leaves); the session still serves."""
    eng = _engine(4, 2, paged_kv=True)
    req = GenerationRequest("tiny", "bucket of two on dp four", max_new_tokens=8)
    solo = eng.generate(req)
    sess = eng.decode_open([req], reserve_rows=1)
    assert sess.b_bucket % 4 != 0
    assert sess.dp_shards == 1
    assert _layouts(sess)["tokens"] == {"heads": None, "rows": None}
    results = _drain(sess)
    assert results[0].tokens == solo.tokens
    sess.close()


def test_dp_continuous_scheduler_serves_sharded_rows():
    """A dp × tp engine behind the continuous scheduler (what ``serve
    --backend torch-tp --tp 2 --dp 2`` builds) admits staggered rows and
    retires them with solo streams; the mesh shows in debug_state."""
    eng = _engine(2, 2, paged_kv=True)
    r1 = GenerationRequest("tiny", "sched dp row one", max_new_tokens=10, stop_at_eos=False)
    r2 = GenerationRequest("tiny", "sched dp row two", max_new_tokens=8, seed=2)
    solo = {id(r): eng.generate(r) for r in (r1, r2)}
    sched = ContinuousScheduler(eng, slice_steps=2)
    sched.start()
    try:
        done = {}

        def run(req):
            done[id(req)] = sched.submit(req)

        threads = [threading.Thread(target=run, args=(r,)) for r in (r1, r2)]
        threads[0].start()
        time.sleep(0.05)
        threads[1].start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "dp scheduler row hung"
        for req in (r1, r2):
            assert done[id(req)].tokens == solo[id(req)].tokens
        assert sched.debug_state()["backend_mesh"]["axes"] == {"dp": 2, "tp": 2}
    finally:
        sched.stop()


def test_tp_deadline_reap_through_continuous_scheduler():
    """A mid-flight deadline expiry on the mesh retires the row through
    the scheduler's reap sweep (session.cancel) and the caller gets
    DeadlineExceeded, not a hang."""
    eng = _engine(1, 2, paged_kv=True)
    sched = ContinuousScheduler(eng, slice_steps=2)
    sched.start()
    try:
        doomed = GenerationRequest(
            "tiny", "doomed long row", max_new_tokens=200, stop_at_eos=False, deadline_ms=300.0,
        )
        errs = {}

        def run():
            try:
                sched.submit(doomed)
            except BaseException as exc:  # noqa: BLE001
                errs["exc"] = exc

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), "deadline-doomed request hung"
        assert isinstance(errs.get("exc"), DeadlineExceeded), errs
        assert sched.debug_state()["backend_mesh"]["devices"] == 2
    finally:
        sched.stop()


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("source,spec", [("ngram", ("ngram", 3)), ("model", ("tiny-d", 3))])
def test_tp_sampled_spec_carry_leaves_stable(n_devices, source, spec):
    """``test_spec_sampled.py``'s mesh case: a sampled speculating session
    on 2 and 8 shards keeps its per-row spec leaves (generators, the
    rejected-rounds counter, the n-gram history or the draft's offsets)
    in one copy and at their shapes across slices, and its sampled rows
    equal the unsharded engine's on the same weights and seeds."""
    draft_cfg = dataclasses.replace(_tiny8(), n_layers=1)
    reg = {"tiny": _tiny8(), "tiny-d": draft_cfg}
    eng = _spec_engine(n_devices, speculative={"tiny": spec})
    base = TorchEngine(registry=reg, dtype=torch.float32, device="cpu", paged_kv=True, speculative={"tiny": spec})
    base.install_model("tiny", _tiny8(), params_from_numpy(_jax_engine(1, 2)[1], "cpu", torch.float32))
    reqs = [
        GenerationRequest("tiny", "mesh row one one one", max_new_tokens=16, temperature=0.7, seed=41,
                          stop_at_eos=False),
        GenerationRequest("tiny", "mesh row two two two", max_new_tokens=16, temperature=0.7, seed=42,
                          stop_at_eos=False),
    ]

    def run(engine):
        sess = engine.decode_open(reqs, reserve_rows=4)
        assert sess.spec is not None and sess.spec["source"] == source
        keys = ["spec_rejected"] + (["ngram_hist", "ngram_len"] if source == "ngram" else ["draft_offsets"])
        shapes = {key: tuple(sess.carry[key].shape) for key in keys}
        layout = _layouts(sess, sess.spec["dcfg"]) if isinstance(engine, TensorParallelEngine) else None
        assert len(sess.carry["gens"]) == sess.b_bucket
        out = sess.step(4)
        assert {key: tuple(sess.carry[key].shape) for key in keys} == shapes
        out += _drain(sess)
        sess.close()
        return {r.request.seed: r.tokens for r in out}, layout, keys

    got, layout, keys = run(eng)
    for key in keys:
        assert layout[key] == {"heads": None, "rows": None}, key
    if source == "model":
        assert layout["draft_k"] == {"heads": "tp", "rows": None}
    want, _, _ = run(base)
    assert got == want
