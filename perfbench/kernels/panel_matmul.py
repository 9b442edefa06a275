"""B5: the subspace solver's (m, m) @ (m, r) panel product, one call a
sweep and one for the Rayleigh-Ritz step."""

DEVICE_KERNELS = ("panel_kernel",)


def count(shape):
    m, r = shape["m"], shape["r"]
    return 2 * m * m * r, 4 * (m * m + 2 * m * r)
