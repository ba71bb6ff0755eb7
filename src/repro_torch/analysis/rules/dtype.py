"""dtype-drift: no float-width change inside the Newton trips.

SUNDIALS realtype semantics: the working precision is chosen once, and
nothing silently promotes (a float32 coefficient must not upcast a
float64 state's arithmetic) or demotes (a float32 copy must not truncate
the float64 iterate).  The reference's rule flags each
``convert_element_type`` between floating dtypes of different widths in
its Newton ``while_loop`` bodies; the port's reads the dispatch walker's
record of each ``ensemble_bdf`` and ``ensemble_dirk`` Newton trip
(:mod:`..hotloop`) and flags each call that mixes floating widths: an
explicit cast (``.to``, ``copy_``) or an implicit promotion.
``ctx.dtype_allowlist``, a set of ``(source, destination)`` dtype-name
pairs, is the seam for a deliberate mixed-precision cast.
"""
from .. import lint


@lint.register(
    "dtype-drift",
    "no float64<->float32 promotion/truncation inside the ensemble Newton "
    "trips (allowlist = the mixed-precision seam)")
def check(ctx):
    out = []
    for tgt in ctx.hot_loop_targets:
        for f in ctx.hot_loop_trace(tgt).findings:
            if f.rule == "dtype-drift" and f.pair not in ctx.dtype_allowlist:
                out.append(lint.Violation(
                    "dtype-drift", f.key(tgt.name),
                    f"{f.detail} inside a Newton trip (allowlist the pair "
                    "if deliberate)", src=f.src))
    return list(dict.fromkeys(out))     # one per call site and message
