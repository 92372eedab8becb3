"""``test_sampled_spec_matches_plain_distribution`` of the JAX package's
``tests/test_spec_sampled.py`` on the port, on the contiguous bf16-KV layout, for the
model, n-gram and cross-model sources: at temperature 0.7 a speculating
session's pooled tokens pass the file's chi-squared and TV tests against
the plain session's. The case runs one layout a file, so that each file
stays short (the rest of the JAX file, and why one case is left out:
``tests/test_torch_spec_sampled.py``)."""

from test_torch_runner import load_cases, one_torch_thread  # noqa: F401
from test_torch_spec_sampled import RENAMES

LAYOUTS_ALL = """LAYOUTS = [
    pytest.param(False, None, id="contig-bf16"),
    pytest.param(False, "int8", id="contig-int8"),
    pytest.param(True, None, id="paged-bf16"),
    pytest.param(True, "int8", id="paged-int8"),
]"""
LAYOUTS_HERE = """LAYOUTS = [
    pytest.param(False, None, id="contig-bf16"),
]"""
CASES = load_cases(
    globals(), "test_spec_sampled.py", renames=RENAMES + ((LAYOUTS_ALL, LAYOUTS_HERE),),
    only=("test_sampled_spec_matches_plain_distribution",),
)


def test_the_distribution_case_is_loaded_on_the_contig_bf16_layout():
    assert CASES == ["test_sampled_spec_matches_plain_distribution"]
    assert [p.id for p in LAYOUTS] == ["contig-bf16"]
