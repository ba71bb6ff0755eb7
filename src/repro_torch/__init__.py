"""PyTorch/CUDA port of the ``repro`` ensemble-integration stack.

Module names mirror the JAX package (``repro_torch.core.batched`` is the
counterpart of ``repro.core.batched``, and so on).  This package imports
``torch`` and never ``jax`` or anything of ``repro``: what it needs from
the JAX package it keeps as its own copy.

The hot kernels are CUDA C++ for Hopper (``kernels/csrc/*.cu``), built
with ``nvcc`` at first use; each has a plain PyTorch version beside it,
which the wrappers take for tensors that lie on the CPU.

Covered so far: ``core.ivp.integrate`` with the scalar ARKODE families
``"erk[:table]"``, ``"dirk[:table]"`` and ``"imex[:table]"``, the
CVODE families ``"bdf"`` and ``"adams"``, and the ensemble families
``"ensemble_erk[:table]"``, ``"ensemble_dirk[:table]"`` and
``"ensemble_bdf"``, the latter with ``BlockDiagGJ`` (both modes),
``EnsembleSparseGJ`` or a preconditioned Krylov solver (``SPGMR``,
``SPFGMR``, ``SPBCGS``, ``SPTFQMR``, ``PCG``) over a ``jac_sparsity``
pattern; the sparse matrices ``core.sunmatrix.SparseCSR`` and
``EnsembleBSR``; event detection (``core.events``); warm-start sessions
(``core.batched.SolverSession``) and step telemetry; the SUNContext,
SUNMemoryHelper, SUNProfiler and SUNLogger analogs (``core.context``,
``core.memory``, ``observability``); the paper's §7 demonstration,
``apps.brusselator``; the dynamic-batching server ``serve.solver`` and
the fault-injection harness ``testing.chaos``; and the examples
``examples.batched_kinetics``, ``serve_solver_demo``, ``brusselator``
and ``brusselator_sparse``.  Everything else raises
``NotImplementedError`` naming its ROADMAP item.
"""
