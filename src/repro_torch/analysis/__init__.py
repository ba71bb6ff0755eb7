"""Analysis layer of the PyTorch port (counterpart of ``repro.analysis``).

* :mod:`.roofline` — the device table the cost model reads (one row,
  ``h100_sxm``) and :func:`~.roofline.device_for`, which maps a card to
  its row;
* :mod:`.opcost` — each op's signature and its analytical cost under
  both implementations, and the model's predicted winner;
* :mod:`.lint` — sunlint, the port's static checks (rules in
  :mod:`.rules`: ``kernel-contract``, ``table-coherence``,
  ``bounded-loops``), with deliberately bad inputs in :mod:`.fixtures`.

The reference's HLO cost walk (``hlocost.py``) and the rest of its
``roofline.py`` serve only its dry-run launcher and wait for it (ROADMAP
queue A.9).
"""
