"""Integrator core of the PyTorch port (counterpart of ``repro.core``)."""
