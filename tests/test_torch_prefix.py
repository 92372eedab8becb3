"""The JAX package's ``tests/test_prefix.py`` on the port's shared prefix
store, loaded with the package name swapped, over
``TorchEngine(device="cpu")`` at f32 with the JAX file's layouts: page
refcounts, sharers that map the store's read-only pages and match their
solo ``generate`` exactly on both pools, the copy-on-write boundary on
all four layouts, cross-session hits after the publisher's session
closed, exact page accounting under cancel and join abort, the
shared-page admission bill, second-generation tail pages, the contiguous
store's seed-only nodes, the engine's knobs, and a preempted sharer that
releases and re-shares the store's pages.

The port's paged sessions are all stacked (a side cache holds the
generated tokens), where the JAX package on the CPU runs its unstacked
paged session. Two cases read that difference and are loaded with it
named in ``RENAMES``: the admission bill is priced without the JAX
file's ``stacked=False`` argument (the port's helper has no such
argument), and once the store has dropped a parked sharer's pages the
resume swaps the whole prompt in from the copy its preemption took
(a stacked session cannot re-prefill a row whose generated K/V live in
its side caches), where the JAX unstacked session recomputes, so that
case's plan check reads mode "swap" without a re-share; its token check
is the JAX file's. No case is left out."""

from test_torch_runner import load_cases, one_torch_thread  # noqa: F401

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
    ("jax_engine as je", "torch_engine as je"),
    ("[need] + [1] * 63, 64, g_bucket, False", "[need] + [1] * 63, 64, g_bucket"),
    (
        'assert plan is not None and plan["mode"] == "recompute"',
        'assert plan is not None and plan["mode"] == "swap" and not plan["reshare"]',
    ),
)
CASES = load_cases(globals(), "test_prefix.py", renames=RENAMES)


def test_every_prefix_case_is_loaded():
    assert len(CASES) == 17


def _parked_sharer(registry):
    """A session whose joiner shares the anchor's published page, the
    joiner preempted, then the anchor cancelled, so that only the store
    holds the shared run: (engine, session, victim, parked row)."""
    eng = _engine(registry)  # noqa: F821 — the JAX file's, loaded above
    anchor = GenerationRequest(  # noqa: F821
        "tiny", SHARED + " anchor", max_new_tokens=90, stop_at_eos=False, seed=1,  # noqa: F821
    )
    sess = eng.decode_open([anchor], reserve_rows=4)
    sess.step(2)
    victim = GenerationRequest(  # noqa: F821
        "tiny", SHARED + " victim tail", max_new_tokens=24, stop_at_eos=False, seed=5,  # noqa: F821
    )
    sess.join(victim)
    sess.step(4)
    pr = sess.preempt(victim, policy="swap")
    assert pr is not None and pr.shared_pages
    # the shared run is copied with the row's own pages
    assert pr.blob.n_pages == len(pr.shared_pages) + pr.n_own_pages
    sess.cancel(anchor)
    return eng, sess, victim, pr


def test_parked_sharer_resumes_after_the_store_spilled_its_run(registry):
    """The store spills the parked sharer's shared run to host memory
    (a device budget of 0 bytes): the resume cannot re-share it, swaps
    the whole prompt in from the row's copy, and gives the plain
    engine's tokens."""
    eng, sess, victim, pr = _parked_sharer(registry)
    plain = _engine(registry, share=False)  # noqa: F821
    store = eng.prefix_store
    store.hbm_bytes = 0
    store._enforce_budgets("tiny")
    assert store.debug_state()["hbm_pages"] == 0
    plan = sess._resume_plan(pr)
    need = len(pr.shared_pages) + pr.n_own_pages
    assert plan == {"mode": "swap", "need": need, "reshare": False}
    pending = sess.resume_begin(pr)
    assert pending.shared_pages == 0 and len(pending.pages) == need
    while not sess.join_step(pending):
        pass
    sess.join_commit(pending)
    results = {id(r.request): r for r in _drain(sess)}  # noqa: F821
    assert results[id(victim)].tokens == plain.generate(victim).tokens
    sess.close()
    assert sess.pool.free_pages == sess.pool.n_pages - 1


def test_parked_sharer_exports_and_seats_on_another_engine(registry):
    """A sharer's bundle carries every page as its own: it seats on an
    engine without the store and finishes with the plain engine's
    tokens; the source's pool and store keep their references."""
    import json

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.migrate import (
        export_bundle,
        import_bundle,
    )

    eng, sess, victim, pr = _parked_sharer(registry)
    dst = _engine(registry, share=False)  # noqa: F821
    bundle = json.loads(json.dumps(export_bundle(pr, reason="drain")))
    sess.resume_discard(pr)
    assert bundle["n_own_pages"] == bundle["blob"]["n_pages"] == len(pr.shared_pages) + pr.n_own_pages
    d_sess = dst.decode_open([GenerationRequest(  # noqa: F821
        "tiny", "d" * 140 + " destination anchor", max_new_tokens=90, stop_at_eos=False,
    )], reserve_rows=4)
    seated = import_bundle(bundle)
    assert seated.shared_pages == [] and d_sess.can_resume(seated)
    pending = d_sess.resume_begin(seated)
    while not d_sess.join_step(pending):
        pass
    d_sess.join_commit(pending)
    results = {id(r.request): r for r in _drain(d_sess)}  # noqa: F821
    assert results[id(seated.request)].tokens == dst.generate(victim).tokens
    d_sess.close()
    sess.close()
    assert sess.pool.free_pages == sess.pool.n_pages - 1
    assert d_sess.pool.free_pages == d_sess.pool.n_pages - 1
