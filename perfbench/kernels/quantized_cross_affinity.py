"""B1: the (m, m) landmark block W = A(z, z) at the tile precision."""

DEVICE_KERNELS = ("cross_tile_kernel",)


def count(shape):
    m, d = shape["m"], shape["d"]
    return m * m * (2 * d + 5), 4 * (2 * m * d + m * m)
