"""Row 5: the weighted root-mean-square norm of each system's vector
(op ``wrms_soa``).  Reads v and w (n each), writes one norm."""

SYMBOLS = ("wrms_soa_kernel",)


def cost(n, nsys, itemsize):
    return 3 * n * nsys, (2 * n + 1) * nsys * itemsize
