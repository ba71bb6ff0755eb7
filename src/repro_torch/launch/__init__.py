"""Launch helpers of the port (counterpart of ``repro.launch``): the
ensemble's 1-D ``("systems",)`` device layout, :mod:`.mesh`, and the
training launcher, :mod:`.train`."""
