"""hot-loop-layout: no layout conversion inside the Newton trips.

The reference's rule walks its Newton ``while_loop`` bodies for
``transpose`` equations and copying reshapes.  The port's counterpart
reads the dispatch walker's record of each ``ensemble_bdf`` and
``ensemble_dirk`` Newton trip (:mod:`..hotloop`): a permute or transpose
whose result is then copied (``clone``, ``contiguous``, ``copy_``, or a
reshape that materialises) moves every system's data in a loop that the
SoA layout exists to keep copy-free.
"""
from .. import lint


@lint.register(
    "hot-loop-layout",
    "no permuted view copied (clone / contiguous / copy_ / copying "
    "reshape) inside the ensemble Newton trips")
def check(ctx):
    out = []
    for tgt in ctx.hot_loop_targets:
        for f in ctx.hot_loop_trace(tgt).findings:
            if f.rule == "hot-loop-layout":
                out.append(lint.Violation(
                    "hot-loop-layout", f.key(tgt.name),
                    f"{f.detail} inside a Newton trip", src=f.src))
    return list(dict.fromkeys(out))     # one per call site and message
