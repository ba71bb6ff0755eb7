"""Row 4f: the BDF history rebuilt onto a new step ratio, its Lagrange
matrix W formed in the kernel from each system's eta and history count
(op ``lagrange_rescale_soa``).  Reads the history Z (6 rows of n), eta,
the int32 count q and the mask byte; writes Z': 301 bytes a system at
n = 3 in float64.  Flops: W's entries (6 x 6, each a product of 5
factors of 3 flops, at q = 5) and the product W Z.

The same kernels also take W from memory (row 4, ``history_rescale``);
no path of the port launches that form since the fused entry came in,
and a launch of it would be counted here, with fewer bytes than it
moves."""

SYMBOLS = ("history_rescale_kernel", "history_rescale_loop_kernel")
Q1 = 6


def cost(n, nsys, itemsize):
    flops = (Q1 * Q1 * 3 * (Q1 - 1) + Q1 + 2 * Q1 * Q1 * n) * nsys
    nbytes = (2 * Q1 * n + 1) * nsys * itemsize + 4 * nsys + nsys
    return flops, nbytes
