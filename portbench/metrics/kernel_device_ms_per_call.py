"""Device time of the port's own kernels (``kernels/csrc/*.cu``) per
profiled call, in ms."""


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.kernel_s <= 0:
        return None
    return 1e3 * t.kernel_s / t.calls
