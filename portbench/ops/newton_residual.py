"""Row 1: the Newton residual ``gamma f - (z - psi)`` (op
``newton_residual_soa``).  Reads z, f, psi (n each) and gamma, writes
the residual (n)."""

SYMBOLS = ("newton_residual_kernel",)


def cost(n, nsys, itemsize):
    return 3 * n * nsys, (4 * n + 1) * nsys * itemsize
