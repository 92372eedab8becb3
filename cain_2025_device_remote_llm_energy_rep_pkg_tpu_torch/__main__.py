"""``python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch`` entry point.

Reference: ``experiment-runner/__main__.py:52-79``.
"""

import sys

from .runner.cli import main

if __name__ == "__main__":
    sys.exit(main())
