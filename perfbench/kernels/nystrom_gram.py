"""B3: the rotated Gram W^-1/2 (S^T S) W^-1/2 of the degree-normalized
cross-affinity S.  C is rebuilt once, C.u gives the degrees, S^T S is
symmetric so its upper triangle with the diagonal counts (n m (m + 1)),
and the rotation is two general (m, m) products (4 m^3)."""

DEVICE_KERNELS = ("degree_kernel", "gram_tile_kernel", "gram_reduce_kernel",
                  "rot_tile_kernel")


def count(shape):
    n, m, d = shape["n"], shape["m"], shape["d"]
    ops = n * m * (2 * d + 8) + n * m * (m + 1) + 4 * m ** 3
    return ops, 4 * (n * d + m * d + m + 2 * m * m)
