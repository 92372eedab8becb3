"""The JAX package's ``tests/test_spec_stepped.py`` on the port's
speculating session, loaded with the package name swapped, over
``TorchEngine(device="cpu")`` at f32 with the JAX file's layouts: the
contiguous session (the verify block written into each row's cache and
read by the plain version of the multi-query kernel over contiguous
rows) and the paged one (stacked-hybrid), bf16 and int8 KV. Every row,
a mid-flight joiner and a chunked joiner whose draft prefill rides the
join's chunks included, gives plain greedy decode's tokens; sampled rows
and sampled joiners speculate; the adaptive policy shrinks k and falls
back with unchanged tokens; the continuous scheduler drives a
speculating session; the debug state and the solo path's extras.

The port's paged sessions are all stacked-hybrid, so the JAX file's
kernel-less paged engine (``paged_kv=True`` without a decode kernel) is
the stacked one here: ``_stacked_spec_engine`` takes no
``decode_attention``, and ``test_spec_paged_bills_no_slack_and_restores_exactly``
holds the stacked rules (a row pins its prompt's pages, the candidates
sit in the side caches' k overshoot columns) where the JAX file asserts
the scratch leaves and prompt-plus-budget pages of its kernel-less mode.

``test_spec_disabled_when_draft_cache_cannot_fit`` is loaded too: it
fails on the JAX package itself (its plain path retires that row at EOS
after 83 of its 128 tokens, though ``stop_at_eos=False``), and the port
serves the row plain for all 128.

Left out: ``test_spec_stacked_vs_scratch_modes_agree``: the port has no
scratch (kernel-less) verify mode; ``tests/test_torch_spec_modes.py``
holds the port's stacked session against the JAX package's scratch
session."""

from test_torch_runner import load_cases, one_torch_thread  # noqa: F401

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
    (
        '''    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops.pallas_attention import (
        pallas_decode_attention,
    )

''',
        "",
    ),
    ("        decode_attention=pallas_decode_attention, **kwargs,\n", "        **kwargs,\n"),
    (
        '''        assert "scratch_k" in sess.carry and "scratch_v" in sess.carry''',
        '''        side = sess.carry["side_k"]
        assert (side["q"] if kv else side).shape[3] == sess.g_bucket + 3''',
    ),
    ("== -(-(100 + 40) // 128)", "== -(-100 // 128)"),
)
LEFT_OUT = ("test_spec_stacked_vs_scratch_modes_agree",)
CASES = load_cases(globals(), "test_spec_stepped.py", renames=RENAMES, leave_out=LEFT_OUT)


def test_every_spec_stepped_case_is_loaded():
    assert len(CASES) == 11
