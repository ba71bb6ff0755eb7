"""Systems solved through every output time of a solve in the window,
over the time from the start of the first call to the end of the last
(host clock; every call ends in a synchronise, and the window holds
whole solves)."""


def read(run):
    if run.solves == 0 or run.window_s <= 0:
        return None
    return run.nsys * run.solves / run.window_s
