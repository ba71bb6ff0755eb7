"""The port's optimizers (counterpart of ``repro.optim``)."""
from . import adamw, gradflow

__all__ = ["adamw", "gradflow"]
