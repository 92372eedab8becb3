"""The JAX package's ``tests/test_utils.py`` on the port's ``utils/``.

Its cases, loaded with the package name swapped: the dotenv parser and
loader (``utils/env.py``), the memory budget (none on a CPU host), the
fail-fast weight estimate against what ``quantize_params`` allocates on
the port's ``init_params`` (a torch generator in place of the JAX key),
``TorchEngine(device="cpu")``'s refusal of a model over the budget, also
when another model is resident, and the decode bytes-per-step model.

Left out: ``test_enable_compilation_cache_configures_jax``, which sets
JAX's persistent compilation cache; the port compiles no XLA programs
and has no such cache (``utils/compile_cache.py`` was closed, not ported).
"""

from test_torch_runner import engines_on_the_cpu  # noqa: F401  (TorchEngine on the CPU)
from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("    import jax\n    import jax.numpy as jnp\n", "    import torch\n"),
    ("init_params(cfg, jax.random.PRNGKey(0), jnp.float32)",
     "init_params(cfg, torch.Generator().manual_seed(0), torch.float32)"),
)
LEFT_OUT = ("test_enable_compilation_cache_configures_jax",)
CASES = load_cases(globals(), "test_utils.py", renames=RENAMES, leave_out=LEFT_OUT)


def test_every_other_case_is_loaded():
    assert len(CASES) == 10
