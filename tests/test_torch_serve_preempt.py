"""The JAX package's ``tests/test_preempt.py`` on the port's stepped
session and scheduler, loaded with the package name swapped. The
real-engine cases run on ``TorchEngine(device="cpu")`` at f32: a
preempted and resumed row's stream equals its solo ``generate`` (by swap
on the contiguous and the paged session, bf16 and int8; by recompute on
the contiguous one), companions are unperturbed, the pool's free count
and the host-swap gauges return exactly to idle, a preempt during a
pending join and a streaming row's delta cursor survive the park.

Left out:
- ``test_pagepool_swap_roundtrip_exact``: it fills the pool with jax
  arrays (``jnp``, ``jax.device_get``); the port's pool swap is held in
  ``tests/test_torch_serving.py::test_pool_swap_round_trips_pages_exactly``.
  The pool's two swap refusals (a shared or free page, a layout
  mismatch) are loaded.
- the parametrization ``paged-int8-recompute`` of
  ``test_preempt_resume_token_parity``: the port's paged session is the
  stacked one, which refuses ``recompute`` in both packages (the JAX
  file runs it on the CPU's unstacked paged mode, which the port has
  not)."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax\n", "import jax, torch\n"),
    ("                dtype=jnp.float32,\n", '                dtype=torch.float32, device="cpu",\n'),
    (
        '''    [
        (False, None, "swap"),
        (True, None, "swap"),
        (False, "int8", "swap"),
        (True, "int8", "swap"),
        (False, None, "recompute"),
        (True, "int8", "recompute"),
    ],
    ids=[
        "contig-bf16-swap", "paged-bf16-swap", "contig-int8-swap",
        "paged-int8-swap", "contig-bf16-recompute", "paged-int8-recompute",
    ],''',
        '''    [
        (False, None, "swap"),
        (True, None, "swap"),
        (False, "int8", "swap"),
        (True, "int8", "swap"),
        (False, None, "recompute"),
    ],
    ids=[
        "contig-bf16-swap", "paged-bf16-swap", "contig-int8-swap",
        "paged-int8-swap", "contig-bf16-recompute",
    ],''',
    ),
)
LEFT_OUT = ("test_pagepool_swap_roundtrip_exact",)
CASES = load_cases(globals(), "test_preempt.py", renames=RENAMES, leave_out=LEFT_OUT)


def test_every_preempt_case_is_loaded():
    assert len(CASES) == 12
