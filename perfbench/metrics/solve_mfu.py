"""The whole solve's share of the card's f32 peak, in percent: the
operations of the solves published in the window (B1-B4, the two dense
landmark eigensolves at their textbook counts, W's inverse square root,
M's products and k-means, by the frozen counts in ``perfbench/kernels``)
over the window's length on the host's clock and 67 TFLOP/s, the H100's
dense f32 peak.  Nothing in it is read from the device."""

from perfbench.harness import roofline


def read(run):
    ops = sum(roofline.solve_ops(run)
              for p in run.window_publishes() if p.source != "cache")
    return 100.0 * ops / (run.seconds * roofline.PEAK_F32_FLOPS)
