"""k-means over the (n, k) embedding: k-means++ seeding (k distance
passes) and ``iters`` Lloyd steps, each a (n, k) x (k, k) distance
product (2 n k^2 plus the norms) and the one-hot center update (2 n k^2).
"""

DEVICE_KERNELS = ()


def count(shape):
    n, k, iters = shape["n"], shape["k"], shape.get("iters", 25)
    seeding = k * n * (3 * k + 1)
    lloyd = (iters + 1) * (2 * n * k * k + 3 * n * k) + iters * 2 * n * k * k
    return seeding + lloyd, 4 * (iters + 1) * n * k
