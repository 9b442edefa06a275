"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to the device's operations (kernels, copies,
sets) as intervals on the host's clock."""

from __future__ import annotations

import dataclasses
from typing import Optional

ANCHOR = "perfbench.window"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float                  # perf_counter seconds
    end: float


@dataclasses.dataclass
class Trace:
    ops: list                     # DeviceOp, sorted by start
    window: tuple                 # (start, end) the trace covers

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] in which some operation ran."""
        busy, cur_s, cur_e = 0.0, None, None
        for op in self.ops:
            s, e = max(op.start, lo), min(op.end, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def gaps(self, lo: float, hi: float) -> list:
        """[(start, end)] of [lo, hi] in which no operation ran."""
        out, at = [], lo
        for op in self.ops:
            if op.end <= at:
                continue
            if op.start > at:
                out.append((at, min(op.start, hi)))
            at = max(at, op.end)
            if at >= hi:
                break
        if at < hi:
            out.append((at, hi))
        return [(s, e) for s, e in out if e > s]

    def named(self, patterns, lo: float, hi: float) -> list:
        """The operations in [lo, hi] whose name holds one of
        ``patterns``."""
        return [op for op in self.ops if lo <= op.start < hi
                and any(p in op.name for p in patterns)]


class Profiler:
    """CPU and device activity; a user annotation marks the window so
    the device's clock can be set beside the host's."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.anchor = None

    def start(self) -> None:
        self.prof.start()

    def mark(self):
        """Enter the window's annotation (the main thread, at t0)."""
        from torch.profiler import record_function
        self.anchor = record_function(ANCHOR)
        self.anchor.__enter__()

    def stop(self, t0: float, t0_ns: int, hi: float) -> Optional[Trace]:
        """Stop, and return the device operations of [t0, hi]; None where
        the profiler saw no device operation."""
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        if self.anchor is not None:
            self.anchor.__exit__(None, None, None)
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        base_ns = t0_ns
        for e in events:
            if e.name() == ANCHOR:
                base_ns = e.start_ns()
                break
        cuda = self.torch.autograd.DeviceType.CUDA
        ops = []
        for e in events:
            if e.device_type() != cuda:
                continue
            s = t0 + (e.start_ns() - base_ns) * 1e-9
            ops.append(DeviceOp(e.name(), s, s + e.duration_ns() * 1e-9))
        if not ops:
            return None
        ops.sort(key=lambda op: op.start)
        return Trace(ops, (t0, hi))
