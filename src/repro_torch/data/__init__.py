"""The port's data pipeline (counterpart of ``repro.data``)."""
from . import pipeline

__all__ = ["pipeline"]
