"""B2: the column sum of the (n, m) cross-affinity, never stored."""

DEVICE_KERNELS = ("colsum_partial_kernel", "sum_rows_kernel")


def count(shape):
    n, m, d = shape["n"], shape["m"], shape["d"]
    return n * m * (2 * d + 6), 4 * (n * d + m * d + m)
