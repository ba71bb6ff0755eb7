"""Butcher tables for ERK / DIRK / additive IMEX-ARK methods (ARKODE).

The port's own copy of ``repro.core.butcher``: the same tables, entry for
entry, as plain named tuples of Python floats (stage loops unroll over
them in Python, as in ARKODE where the table is fixed per integrator
instance).  ``tests/test_torch_ensemble_dirk.py`` holds every table
equal to the reference's bit for bit.

Included (all from the ARKODE set / literature):
* ERK: euler (1), heun_euler 2(1), bogacki_shampine 3(2),
  dormand_prince 5(4).
* DIRK: sdirk2 2(1) (L-stable, gamma = 1 - 1/sqrt(2)), sdirk33 3(2)
  (Alexander), implicit_euler, esdirk3 = the implicit half of
  ARK3(2)4L[2]SA.
* IMEX: ars222 (Ascher-Ruuth-Spiteri 2,2,2),
  ark324 = ARK3(2)4L[2]SA (Kennedy & Carpenter 2003) — ARKODE's default
  3rd-order IMEX pair with embedded 2nd-order error estimate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence


class ButcherTable(NamedTuple):
    A: Sequence[Sequence[float]]
    b: Sequence[float]
    c: Sequence[float]
    order: int
    b_emb: Optional[Sequence[float]] = None   # embedded weights (order-1 est.)
    emb_order: int = 0

    @property
    def stages(self) -> int:
        return len(self.b)

    @property
    def explicit(self) -> bool:
        return all(self.A[i][j] == 0.0
                   for i in range(self.stages)
                   for j in range(i, self.stages))

    @property
    def diag(self) -> Sequence[float]:
        return [self.A[i][i] for i in range(self.stages)]


class IMEXTable(NamedTuple):
    """Additive pair: explicit table for f_E, implicit table for f_I.

    Shared c and (for our pairs) shared b, per Kennedy-Carpenter ARK.
    """
    expl: ButcherTable
    impl: ButcherTable
    order: int
    emb_order: int


# ----------------------------------------------------------------------------
# Explicit tables
# ----------------------------------------------------------------------------

EULER = ButcherTable(A=[[0.0]], b=[1.0], c=[0.0], order=1)

HEUN_EULER = ButcherTable(  # 2(1)
    A=[[0.0, 0.0],
       [1.0, 0.0]],
    b=[0.5, 0.5],
    c=[0.0, 1.0],
    order=2,
    b_emb=[1.0, 0.0],
    emb_order=1,
)

BOGACKI_SHAMPINE = ButcherTable(  # 3(2), FSAL ignored (we re-eval)
    A=[[0.0, 0.0, 0.0, 0.0],
       [1 / 2, 0.0, 0.0, 0.0],
       [0.0, 3 / 4, 0.0, 0.0],
       [2 / 9, 1 / 3, 4 / 9, 0.0]],
    b=[2 / 9, 1 / 3, 4 / 9, 0.0],
    c=[0.0, 1 / 2, 3 / 4, 1.0],
    order=3,
    b_emb=[7 / 24, 1 / 4, 1 / 3, 1 / 8],
    emb_order=2,
)

DORMAND_PRINCE = ButcherTable(  # 5(4)
    A=[[0, 0, 0, 0, 0, 0, 0],
       [1 / 5, 0, 0, 0, 0, 0, 0],
       [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
       [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
       [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
       [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
       [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]],
    b=[35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    c=[0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1],
    order=5,
    b_emb=[5179 / 57600, 0, 7571 / 16695, 393 / 640,
           -92097 / 339200, 187 / 2100, 1 / 40],
    emb_order=4,
)

# ----------------------------------------------------------------------------
# Diagonally implicit tables
# ----------------------------------------------------------------------------

_G = 1.0 - 1.0 / math.sqrt(2.0)  # SDIRK gamma, L-stable

SDIRK2 = ButcherTable(  # SDIRK-2-1-2 (ARKODE): 2 stages, order 2, emb 1
    A=[[_G, 0.0],
       [1.0 - _G, _G]],
    b=[1.0 - _G, _G],
    c=[_G, 1.0],
    order=2,
    b_emb=[0.5, 0.5],
    emb_order=1,
)

# Implicit Euler (for very stiff sanity tests)
IMPLICIT_EULER = ButcherTable(A=[[1.0]], b=[1.0], c=[1.0], order=1)

# Alexander (1977) 3-stage L-stable SDIRK of order 3 ("SDIRK-3-3").
# gamma is the root of x^3 - 3x^2 + 3x/2 - 1/6 in (0.3, 0.6); the
# embedded order-2 weights solve sum(bh)=1, bh.c=1/2 with bh[2]=0.
_G3 = 0.43586652150845967
_C32 = (1.0 + _G3) / 2.0
_B31 = -(6.0 * _G3 * _G3 - 16.0 * _G3 + 1.0) / 4.0
_B32 = (6.0 * _G3 * _G3 - 20.0 * _G3 + 5.0) / 4.0
_BH32 = (0.5 - _G3) / (_C32 - _G3)

SDIRK33 = ButcherTable(
    A=[[_G3, 0.0, 0.0],
       [_C32 - _G3, _G3, 0.0],
       [_B31, _B32, _G3]],
    b=[_B31, _B32, _G3],
    c=[_G3, _C32, 1.0],
    order=3,
    b_emb=[1.0 - _BH32, _BH32, 0.0],
    emb_order=2,
)

# ----------------------------------------------------------------------------
# ARK3(2)4L[2]SA — Kennedy & Carpenter (2003).  ARKODE's default 3rd-order
# IMEX pair (4 stages, ESDIRK implicit part, stiffly accurate, L-stable).
# ----------------------------------------------------------------------------

_g = 1767732205903 / 4055673282236  # the ESDIRK diagonal

_ARK324_c = [0.0, 1767732205903 / 2027836641118, 3 / 5, 1.0]
_ARK324_b = [1471266399579 / 7840856788654,
             -4482444167858 / 7529755066697,
             11266239266428 / 11593286722821,
             _g]
_ARK324_bemb = [2756255671327 / 12835298489170,
                -10771552573575 / 22201958757719,
                9247589265047 / 10645013368117,
                2193209047091 / 5459859503100]

ARK324_ERK = ButcherTable(
    A=[[0.0, 0.0, 0.0, 0.0],
       [1767732205903 / 2027836641118, 0.0, 0.0, 0.0],
       [5535828885825 / 10492691773637, 788022342437 / 10882634858940, 0.0, 0.0],
       [6485989280629 / 16251701735622, -4246266847089 / 9704473918619,
        10755448449292 / 10357097424841, 0.0]],
    b=_ARK324_b, c=_ARK324_c, order=3, b_emb=_ARK324_bemb, emb_order=2)

ARK324_ESDIRK = ButcherTable(
    A=[[0.0, 0.0, 0.0, 0.0],
       [_g, _g, 0.0, 0.0],
       [2746238789719 / 10658868560708, -640167445237 / 6845629431997, _g, 0.0],
       [1471266399579 / 7840856788654, -4482444167858 / 7529755066697,
        11266239266428 / 11593286722821, _g]],
    b=_ARK324_b, c=_ARK324_c, order=3, b_emb=_ARK324_bemb, emb_order=2)

ARK324 = IMEXTable(expl=ARK324_ERK, impl=ARK324_ESDIRK, order=3, emb_order=2)

# ----------------------------------------------------------------------------
# ARS(2,2,2) — Ascher, Ruuth & Spiteri 1997.  2nd order, no embedding
# (used fixed-step or with step-doubling error estimation).
# ----------------------------------------------------------------------------

_d = 1.0 - 1.0 / (2.0 * _G)

ARS222_ERK = ButcherTable(
    A=[[0.0, 0.0, 0.0],
       [_G, 0.0, 0.0],
       [_d, 1.0 - _d, 0.0]],
    b=[_d, 1.0 - _d, 0.0],
    c=[0.0, _G, 1.0],
    order=2)

ARS222_DIRK = ButcherTable(
    A=[[0.0, 0.0, 0.0],
       [0.0, _G, 0.0],
       [0.0, 1.0 - _G, _G]],
    b=[0.0, 1.0 - _G, _G],
    c=[0.0, _G, 1.0],
    order=2)

ARS222 = IMEXTable(expl=ARS222_ERK, impl=ARS222_DIRK, order=2, emb_order=0)

ERK_TABLES = {"euler": EULER, "heun_euler": HEUN_EULER,
              "bogacki_shampine": BOGACKI_SHAMPINE,
              "dormand_prince": DORMAND_PRINCE}
DIRK_TABLES = {"sdirk2": SDIRK2, "sdirk33": SDIRK33,
               "implicit_euler": IMPLICIT_EULER,
               "ark324_esdirk": ARK324_ESDIRK}
IMEX_TABLES = {"ark324": ARK324, "ars222": ARS222}
