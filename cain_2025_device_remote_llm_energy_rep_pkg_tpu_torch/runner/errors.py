"""Typed error taxonomy for the experiment kernel.

Reference: ``ConfigValidator/CustomErrors/*`` (BaseError.py:3-5, ConfigErrors.py:4-21,
CLIErrors.py:3-13, ExperimentOutputErrors.py:4-9, ProgressErrors.py:3-8). The
reference colors messages with ANSI escapes inside the exception text; here
coloring is the logger's job and exceptions stay plain.
"""


class ExperimentError(Exception):
    """Root of the framework's error taxonomy."""


class ConfigError(ExperimentError):
    """The experiment config is structurally invalid (bad types, paths, hooks)."""


class ConfigLoadError(ConfigError):
    """The config file could not be imported or contains no ExperimentConfig."""


class RunTableError(ExperimentError):
    """Run-table construction failed (duplicate treatments/columns, bad exclusion)."""


class PersistenceError(ExperimentError):
    """Reading or writing experiment artifacts (CSV/JSON) failed."""


class ResumeError(ExperimentError):
    """The on-disk experiment state is incompatible with the current config."""


class AllRunsCompletedError(ResumeError):
    """Restarted an experiment whose runs are all DONE.

    The reference defines ``AllRunsCompletedOnRestartError`` but raises a plain
    ``BaseError`` instead (ExperimentController.py:50-52); here the typed error
    is actually raised.
    """


class RunFailedError(ExperimentError):
    """A run's subprocess raised; carries the child traceback text."""

    def __init__(self, run_id: str, child_traceback: str):
        super().__init__(
            f"run {run_id!r} failed in subprocess:\n{child_traceback}"
        )
        self.run_id = run_id
        self.child_traceback = child_traceback


class CommandError(ExperimentError):
    """Unknown CLI command or invalid CLI arguments."""
