"""Integrator core of the PyTorch port (counterpart of ``repro.core``).

Layers (mirroring the SUNDIALS class structure):
  context    — SUNContext analog: ExecPolicy + MemoryHelper + counters
  vector     — N_Vector ops, MeshVector (MPIPlusX), ManyVector
  memory     — SUNMemoryHelper analog (workspace high-water audit)
  policies   — ExecPolicy (plain versions vs CUDA kernels, per-op pins)
  dispatch   — the op table every hot op is routed through
  autotune   — "auto"'s decisions: persisted cache, resolver, tuner
  butcher    — ERK/DIRK/IMEX Butcher tables
  controller — step-size controllers
  linsol     — SUNLinearSolver objects (SPGMR/.../DenseGJ/BlockDiagGJ)
  nonlinsol  — SUNNonlinearSolver objects (Newton, Anderson fixed-point)
  arkode     — adaptive ERK / DIRK / IMEX-ARK integrators
  cvode      — adaptive BDF + functional Adams
  kinsol     — Newton + Anderson fixed-point solvers
  krylov     — GMRES/FGMRES/BiCGStab/TFQMR/PCG (matrix-free)
  matrix     — dense + low-storage block-diagonal matrices
  direct     — batched block-diagonal direct solver
  batched    — ensemble integration (submodel use case), also sharded
               over the ranks of a ``("systems",)`` layout
  ivp        — unified front-end: IVP + integrate(method=...) -> Solution
"""
