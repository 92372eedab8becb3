"""The framework-free cases of the JAX package's ``tests/test_tokenizer.py``
on the port's ``models/tokenizer.py``, loaded with the package name
swapped: the byte tokenizer's surface, an HF tokenizer's round trip and
special ids, and the fall back to bytes. The fourth case,
``test_engine_uses_checkpoint_tokenizer``, has its port twin of the same
name in ``tests/test_torch_convert.py``.
"""

from test_torch_runner import load_cases

ONLY = (
    "test_byte_tokenizer_uniform_surface",
    "test_hf_tokenizer_roundtrip_and_special_ids",
    "test_load_tokenizer_falls_back_to_bytes",
)
CASES = load_cases(globals(), "test_tokenizer.py", only=ONLY)
