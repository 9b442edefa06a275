"""A dense symmetric eigensolve with vectors (the library's), (m, m):
4 m^3 operations (Householder tridiagonalization 4/3 m^3 and the
eigenvectors' back-transformation and divide-and-conquer taken as
8/3 m^3)."""

DEVICE_KERNELS = ()


def count(shape):
    m = shape["m"]
    return 4 * m ** 3, 4 * 2 * m * m
