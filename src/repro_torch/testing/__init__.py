"""Deterministic fault-injection (chaos) tooling for the
fault-containment contract: :mod:`repro_torch.testing.chaos`
(counterpart of ``repro.testing.chaos``)."""
