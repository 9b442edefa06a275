"""B3's share of its roofline: the bound of the launches in the window
(the frozen count at the cell's (n, m, d)) over the device time of B3's
kernels there, in percent."""

from perfbench.harness import roofline


def read(run):
    return roofline.share(run, "nystrom_gram", "gram_tile_kernel",
                          lambda shape: [shape])
