"""Row 1+2+3f: the whole Newton iteration of ``BlockDiagGJ()`` at
b <= 8 (op ``newton_update_soa``).  Reads z, f, psi, w (b each), gamma,
gamrat, the saved inverse (b^2) and the mask byte; writes z' (b) and dn:
217 bytes a system at b = 3 in float64."""

SYMBOLS = ("newton_update_kernel",)


def cost(n, nsys, itemsize):
    flops = (2 * n * n + 10 * n + 3) * nsys
    nbytes = (n * n + 5 * n + 3) * nsys * itemsize + nsys
    return flops, nbytes
