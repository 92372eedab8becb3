"""The rest of the JAX package's ``tests/test_engine.py`` on the port.

``tests/test_torch_engine_contiguous.py`` and
``tests/test_torch_prefix_cache.py`` load its batch, residency and
prefix-cache cases; this module loads the others that do not depend on
the framework, with the package name swapped, onto
``TorchEngine(device="cpu")`` (``engines_on_the_cpu``): the fake
backend, bucket rounding, solo generation (greedy and seeded sampling,
several families, the exact budget, the cache bound, unloading), streams
equal to ``generate``, ``top_p`` and the repeat penalty, warm-up, chunked
and over-long prompts, stop strings and their search, the empty-input
checks, the protocol's cap and per-model quantization.

Two cases are loaded with their reads of compiled-function caches
replaced: ``test_generate_with_top_p_and_repeat_penalty`` without its
check that the knobs got their own compiled decode entries, and
``test_chunked_prefill_matches_single_chunk`` counting prefill forwards
(``_spy_prefill_calls``, as the grouped-prefill cases do) where the JAX
file counts compiled prefill functions. The port compiles nothing.

Left out, each depending on the framework:
- ``test_jax_engine_compile_cache_reused`` and
  ``test_warmup_compiles_stream_decode_bucket`` count or read the JAX
  engine's compiled ``jit`` functions;
- ``test_auto_policy_engages_specialised_kernels_on_tpu`` mocks a TPU
  backend to test the Pallas kernels' "auto" policy; the port always
  runs its kernels on the card;
- ``test_assemble_rows_matches_naive_assembly_randomized`` and
  ``test_assemble_rows_identity_fast_paths`` feed ``jnp`` arrays and JAX
  PRNG keys to ``_assemble_rows``; the port's rows carry torch tensors
  and generators, and the port's twins of both cases are below;
- ``test_max_batch_rows_paged_estimates_are_mode_aware``, for the reason
  ``tests/test_torch_engine_contiguous.py`` gives.
"""

import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config as jax_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from test_torch_engine_contiguous import ENGINE_CASES, ENGINE_RENAMES
from test_torch_prefix_cache import ENGINE_CASES as PREFIX_CASES
from test_torch_runner import engines_on_the_cpu  # noqa: F401  (TorchEngine on the CPU)
from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

LEFT_OUT = (
    "test_jax_engine_compile_cache_reused",
    "test_warmup_compiles_stream_decode_bucket",
    "test_auto_policy_engages_specialised_kernels_on_tpu",
    "test_assemble_rows_matches_naive_assembly_randomized",
    "test_assemble_rows_identity_fast_paths",
    "test_max_batch_rows_paged_estimates_are_mode_aware",
)
RENAMES = ENGINE_RENAMES + (
    ("    assert r1.generated_tokens >= 1\n"
     "    # the static-flag variants get their own compiled decode entries\n"
     "    assert any(k[3] or k[4] for k in engine._decode_cache)\n",
     "    assert r1.generated_tokens >= 1\n"),
    ("    chunked = chunked_engine.generate(req)\n",
     "    calls = _spy_prefill_calls(monkeypatch, chunked_engine)\n"
     "    chunked = chunked_engine.generate(req)\n"),
    ("    assert len(chunked_engine._prefill_cache) >= 2\n", "    assert len(calls) >= 2\n"),
)
CASES = load_cases(globals(), "test_engine.py", renames=RENAMES,
                   leave_out=LEFT_OUT + tuple(ENGINE_CASES) + tuple(PREFIX_CASES))


def test_the_cases_are_those_no_other_module_loads():
    assert len(CASES) == 26
    assert not set(CASES) & (set(ENGINE_CASES) | set(PREFIX_CASES))


# -- the port's twins of the two ``_assemble_rows`` cases ---------------------


def _engines():
    cfg = get_model_config("qwen2:1.5b").tiny()
    return (TorchEngine(registry={"tiny-a": cfg}, dtype=torch.float32, device="cpu"),
            JaxEngine(registry={"tiny-a": jax_config("qwen2:1.5b").tiny()}))


def _naive(states, b_bucket, field):
    """Each row's value, group rows by their index into the group, then
    row 0 repeated over the pad rows."""
    rows = [st["group"][field][st["gi"]] if "group" in st else st[field][0] for st in states]
    return rows + [rows[0]] * (b_bucket - len(states))


@pytest.mark.parametrize("trial", range(12))
def test_assemble_rows_matches_naive_assembly_randomized(trial):
    """Grouped and solo rows in a random order: the port's one-gather
    assembly equals the row-by-row one, for the first tokens (against the
    JAX engine's ``_assemble_rows`` on the same numpy draws too) and for
    the per-row generators, which must come back as the same objects."""
    engine, jax_engine = _engines()
    rng = np.random.default_rng(7 + trial)
    groups = []
    for _ in range(int(rng.integers(0, 3))):
        gb = int(rng.choice([2, 4]))
        first = rng.integers(0, 99, gb)
        groups.append(({"first": torch.tensor(first, dtype=torch.int32),
                        "gen": [torch.Generator() for _ in range(gb)],
                        "np": first},
                       list(rng.permutation(gb))[: int(rng.integers(1, gb + 1))]))
    solos = []
    for _ in range(int(rng.integers(0 if groups else 1, 3))):
        first = rng.integers(0, 99, 1)
        solos.append({"first": torch.tensor(first, dtype=torch.int32), "gen": [torch.Generator()], "np": first})
    entries = [("g", g, int(m)) for g, (_, members) in enumerate(groups) for m in members]
    entries += [("s", s, None) for s in range(len(solos))]
    states, jax_states = [], []
    for idx in rng.permutation(len(entries)):
        kind, a, gi = entries[idx]
        if kind == "g":
            states.append({"group": groups[a][0], "gi": gi})
            jax_states.append({"group": {"first": groups[a][0]["np"]}, "gi": gi})
        else:
            states.append({"first": solos[a]["first"], "gen": solos[a]["gen"][0]})
            jax_states.append({"first": solos[a]["np"]})
    b_bucket = next(b for b in (1, 2, 4, 8, 16) if b >= len(states))

    asm = engine._assemble_rows(states, b_bucket, engine._row_field_specs(states))

    want_first = [int(v) for v in _naive(states, b_bucket, "first")]
    assert asm["first"].tolist() == want_first
    gens = [st["group"]["gen"][st["gi"]] if "group" in st else st["gen"] for st in states]
    gens += [gens[0]] * (b_bucket - len(states))
    assert all(a is b for a, b in zip(asm["gen"], gens)) and len(asm["gen"]) == b_bucket
    jax_fields = [("first", "first", 0, lambda rows: np.concatenate([jax_states[r]["first"] for r in rows]))]
    jax_asm = jax_engine._assemble_rows(jax_states, b_bucket, jax_fields)
    assert np.asarray(jax_asm["first"]).tolist() == want_first


def test_assemble_rows_identity_fast_paths():
    """One full group whose members come in index order fills the bucket
    exactly: the port returns the group's own tensor (no copy) and its
    generators in order. The same group in reverse must not take that
    path: its rows come back reversed."""
    engine, _ = _engines()
    gb = 4
    shared = {"first": torch.tensor([10, 11, 12, 13], dtype=torch.int32),
              "gen": [torch.Generator() for _ in range(gb)]}
    states = [{"group": shared, "gi": i} for i in range(gb)]
    asm = engine._assemble_rows(states, gb, engine._row_field_specs(states))
    assert asm["first"] is shared["first"]
    assert all(a is b for a, b in zip(asm["gen"], shared["gen"]))

    rev = [{"group": shared, "gi": gb - 1 - i} for i in range(gb)]
    asm = engine._assemble_rows(rev, gb, engine._row_field_specs(rev))
    assert asm["first"].tolist() == [13, 12, 11, 10]
    assert all(a is b for a, b in zip(asm["gen"], shared["gen"][::-1]))
