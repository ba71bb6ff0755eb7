"""Device time of every kernel, copy and fill that is not one of the
port's own (aten's kernels: the loops' plain tensor code), per profiled
call, in ms."""


def read(run):
    t = run.trace
    if t is None or t.calls == 0:
        return None
    return 1e3 * t.plain_s / t.calls
