"""Row 6f: the lsetup of ``BlockDiagGJ()`` at b <= 8, the Newton blocks
M = I - gamma J formed inside the Gauss-Jordan inverse (op
``newton_block_inverse_soa``).  Reads J (b^2) and gamma, writes M^-1
(b^2): 152 bytes a system at b = 3 in float64."""

SYMBOLS = ("newton_block_inverse_kernel",)


def cost(n, nsys, itemsize):
    flops = (4 * n ** 3 + 2 * n * n) * nsys
    nbytes = (2 * n * n + 1) * nsys * itemsize
    return flops, nbytes
