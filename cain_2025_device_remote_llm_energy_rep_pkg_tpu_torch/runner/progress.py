"""Run progress states.

Reference: ``ProgressManager/RunTable/Models/RunProgress.py:3-5`` (TODO=1, DONE=2).
String values here so the CSV cell is self-describing ("TODO"/"DONE"/"FAILED")
rather than a bare int.
"""

import enum


class RunProgress(str, enum.Enum):
    TODO = "TODO"
    DONE = "DONE"
    # New over the reference: a run that raised can be marked FAILED (and is
    # retried on resume) instead of aborting the whole sweep.
    FAILED = "FAILED"

    def __str__(self) -> str:  # CSV cells render as the bare word
        return self.value
