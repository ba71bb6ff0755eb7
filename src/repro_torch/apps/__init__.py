"""Applications of the port (counterparts of ``repro.apps``)."""
