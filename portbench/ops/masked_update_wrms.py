"""Row 3: the masked Newton update and the correction's norm (op
``masked_update_wrms_soa``).  Reads z, dz, w (n each) and the mask byte,
writes z' (n) and dn."""

SYMBOLS = ("masked_update_wrms_kernel",)


def cost(n, nsys, itemsize):
    return 6 * n * nsys, (4 * n + 1) * nsys * itemsize + nsys
