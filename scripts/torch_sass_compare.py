#!/usr/bin/env python3
"""Compare the SASS of this checkout's CUDA kernels with another checkout's.

Run from the repository root on a machine with ``nvcc`` and ``cuobjdump``
(the CUDA toolkit), with the other checkout unpacked beside it (for
example ``git archive <commit> | tar -x -C chip_check/parent``):

    python3 scripts/torch_sass_compare.py chip_check/parent

Both trees' libraries are built from their own ``csrc/`` (into each tree's
git-ignored ``_build/``). Every kernel function the two builds share is
compared instruction for instruction, its addresses stripped, its runs
of blanks collapsed and its branch labels renumbered within the function;
kernels in anonymous namespaces are matched across the two files'
digests. A kernel
whose name changed (a template parameter added, say) is matched by its
body: each kernel found in only one build whose SASS equals that of a
kernel found only in the other is listed as a renamed pair. Prints one
JSON object: ``{"same": [...], "different": [...], "renamed_same":
[[this, other], ...], "only_this": [...], "only_other": [...]}`` of
kernel names, and exits 1 if any shared kernel differs.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch"
LIBRARIES = ("attention", "paged_attention", "int4_matmul")


def kernels_module(root: Path):
    """The ``ops/_kernels.py`` of the tree at ``root``, loaded on its own so
    that it builds into that tree."""
    spec = importlib.util.spec_from_file_location(f"_kernels_{abs(hash(str(root)))}",
                                                  root / PKG / "ops" / "_kernels.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sass_functions(kernels, lib: str) -> "dict[str, list[str]]":
    """Kernel name -> SASS lines (addresses stripped) of one built library."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(kernels.library_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        lines = block.splitlines()
        # an anonymous namespace is mangled with a digest of its source file
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", lines[0].strip())
        name = re.sub(r"^_ZN\d+_GLOBAL", "_ZN_GLOBAL", name)
        # cuobjdump pads its columns to the file's longest line: runs of
        # blanks are one blank
        body = [" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split()) for ln in lines[1:]]
        # branch labels (.L_x_N) are numbered over the whole file: renumber
        # them within the function, in order of first appearance
        labels = {}
        body = [re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(m.group(0), f".L_{len(labels)}"), ln)
                for ln in body]
        out[name] = [ln for ln in body if ln]
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other_root = Path(sys.argv[1]).resolve()
    this, other = kernels_module(ROOT), kernels_module(other_root)
    this.build()
    other.build()
    report = {"same": [], "different": [], "renamed_same": [], "only_this": [], "only_other": []}
    for lib in LIBRARIES:
        a, b = sass_functions(this, lib), sass_functions(other, lib)
        only_other = sorted(set(b) - set(a))
        for name in sorted(set(a) | set(b)):
            if name in a and name in b:
                report["same" if a[name] == b[name] else "different"].append(name)
            elif name in a:
                twin = next((o for o in only_other if b[o] == a[name]), None)
                if twin is None:
                    report["only_this"].append(name)
                else:
                    only_other.remove(twin)
                    report["renamed_same"].append([name, twin])
        report["only_other"].extend(only_other)
    print(json.dumps(report, indent=1))
    return 1 if report["different"] else 0


if __name__ == "__main__":
    sys.exit(main())
