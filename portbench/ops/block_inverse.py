"""Rows 6 and 7: the Gauss-Jordan inverse of each system's block, the
lsetup of ``BlockDiagGJ()`` above b = 8 (op ``block_inverse_soa``).
Reads the block (b^2), writes its inverse (b^2)."""

SYMBOLS = ("gj_inverse_unrolled_kernel", "gj_inverse_warp_kernel",
           "gj_inverse_inplace_kernel")


def cost(n, nsys, itemsize):
    return 4 * n ** 3 * nsys, 2 * n * n * nsys * itemsize
