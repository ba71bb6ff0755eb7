"""Percent: the least time the port's kernel launches in the profile
need at the cell's shapes (each the larger of its operation's bytes over
the card's peak bandwidth and its flops over its peak rate, by the
``ops/`` files) over their device time.  Launches of a kernel with no
``ops/`` file are left out of both, and named on standard error."""


def read(run):
    t = run.trace
    return None if t is None else t.roofline_share
