"""Row 2: the block-diagonal SpMV against the saved inverse, the lsolve
of ``BlockDiagGJ()`` above b = 8 (op ``blockdiag_spmv_soa``).  Reads the
blocks (b^2) and x (b), writes y (b)."""

SYMBOLS = ("spmv_fixed_kernel", "spmv_rows_kernel", "spmv_any_kernel")


def cost(n, nsys, itemsize):
    return 2 * n * n * nsys, (n * n + 2 * n) * nsys * itemsize
