"""Serving front-ends of the port: :mod:`repro_torch.serve.solver`, the
dynamic-batching IVP server (counterpart of ``repro.serve.solver``)."""
