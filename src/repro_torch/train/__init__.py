"""The port's training infrastructure (counterpart of ``repro.train``):
the step (:mod:`.step`), checkpoints (:mod:`.checkpoint`) and the fault
bookkeeping (:mod:`.fault`)."""
from . import checkpoint, fault, step

__all__ = ["checkpoint", "fault", "step"]
