"""B4: the row-normalized extension row_normalize(S . proj), (n, k)."""

DEVICE_KERNELS = ("pack_landmarks_kernel", "extension_kernel")


def count(shape):
    n, m, d, k = shape["n"], shape["m"], shape["d"], shape["k"]
    ops = n * m * (2 * d + 8 + 2 * k) + 3 * n * k
    return ops, 4 * (n * d + m * d + m + m * k + n * k)
