"""Roofline and mfu arithmetic over the frozen kernel counts
(``perfbench/kernels``) and the device trace."""

from __future__ import annotations

from perfbench.harness import registry
from perfbench.harness.peaks import PEAK_F32_FLOPS, bound_s

__all__ = ["PEAK_F32_FLOPS", "shape", "share", "solve_ops"]


def shape(run) -> dict:
    """The solve's sizes, as the kernel counts take them."""
    cfg = run.config
    return {"n": cfg["num_clients"], "m": cfg["num_landmarks"],
            "d": cfg["embed_dim"], "k": cfg["num_clusters"]}


def share(run, kernel: str, launch_marker: str, shapes_of) -> float | None:
    """Percent of the roofline: the bound of the kernel's launches in
    the window over its kernels' device time there.  A call is counted
    by ``launch_marker``, one device kernel of each call; its launches
    split evenly over ``shapes_of(shape)``."""
    if run.trace is None:
        return None
    mod = registry.module("kernels", kernel)
    ops = run.trace.named(mod.DEVICE_KERNELS, run.t0, run.close)
    calls = sum(1 for op in ops if launch_marker in op.name)
    busy = sum(op.end - op.start for op in ops)
    if not calls or busy <= 0:
        return None
    shapes = shapes_of(shape(run))
    per_call = sum(bound_s(*mod.count(s)) for s in shapes) / len(shapes)
    return 100.0 * calls * per_call / busy


def solve_ops(run) -> float:
    """Operations of one solve by the frozen counts: B1-B4, the two dense
    landmark eigensolves, W's inverse square root and M's products
    (2 m^3) and k-means."""
    s = shape(run)

    def ops(kernel, **kw):
        return registry.module("kernels", kernel).count(dict(s, **kw))[0]

    m = s["m"]
    total = sum(ops(name) for name in ("quantized_cross_affinity",
                                       "nystrom_colsum", "nystrom_gram",
                                       "nystrom_extension"))
    total += ops("kmeans", iters=25)
    total += 2 * ops("eigh", m=m) + 2 * m ** 3
    return float(total)
