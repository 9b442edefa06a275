"""A step's work, memory and cross-device copies, counted per device as
it runs.

:class:`StepCounter` is a ``TorchDispatchMode``: every aten op the step
runs passes through it, on real tensors or on fake ones
(``torch._subclasses.fake_tensor.FakeTensorMode``, where the dry run
runs, ``launch/steps.py::lower_step``).  Per device of the mesh it
counts:

* FLOPs, through ``torch.utils.flop_counter``'s registry (the matmuls,
  convolutions and attention ops it knows), each op's to the device of
  its output, with the same decomposition of the other ops as
  ``FlopCounterMode``, so the two give one count;
* bytes accessed: every op's tensor inputs and outputs, each on its own
  device, a view (an output that aliases an input without writing it)
  costing nothing.  Eager PyTorch reads and writes device memory for
  each op, so this is the traffic of the eager program, with no fusion;
* live memory: each storage an op allocates is counted from its first
  appearance until it is freed (a ``weakref.finalize`` on the storage),
  on top of the storages given as arguments; the peak is the most live
  at any point of the run.  The card's caching allocator rounds each
  block up (to 512 bytes), which this does not;
* copies between two different devices of the mesh (``aten._to_copy``
  and ``aten.copy_``), by (source, destination) and by the kind of
  collective they were made in (``models/parallel.py::collective``;
  ``other`` outside one).

A kernel wrapper whose shape-only route serves a fake tensor
(``kernels/flash_attention.py``, ``kernels/ssd.py``) adds its kernel's
work through :meth:`StepCounter.kernel_work` (:func:`kernel_work` finds
the counters on the mode stack).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.models.parallel import collective_kind
from repro_torch.tree import leaves

_aten = torch.ops.aten

# size and stride queries: no work (as ``FlopCounterMode`` skips them)
_METADATA = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
             _aten.is_contiguous.memory_format,
             _aten.is_strides_like_format.default,
             _aten.is_non_overlapping_and_dense.default,
             _aten.size.default, _aten.sym_size.default,
             _aten.stride.default, _aten.sym_stride.default,
             _aten.storage_offset.default,
             _aten.sym_storage_offset.default, _aten.numel.default,
             _aten.sym_numel.default, _aten.dim.default,
             torch.ops.prim.layout.default}
_COPIES = {_aten._to_copy.default, _aten.copy_.default}
# allocations that write nothing
_EMPTY = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default}


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _leaf_tensors(tree) -> list:
    """The tensors of a step's tree, a ``Sharded`` leaf's shards one by
    one (Python scalars skipped)."""
    return [t for x in leaves(tree) for t in getattr(x, "shards", [x])
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_TRAITS: Dict[object, Tuple[bool, bool]] = {}


def _traits(func) -> Tuple[bool, bool]:
    """(moves bytes, allocates) of an aten op, from its schema: it reads
    or writes device memory unless it is a view (every return an alias
    that does not write) or an empty allocation; it allocates where a
    return aliases no input."""
    traits = _TRAITS.get(func)
    if traits is None:
        returns = func._schema.returns
        view = all(r.alias_info is not None and not r.alias_info.is_write
                   for r in returns)
        traits = _TRAITS[func] = (
            func not in _EMPTY and not view,
            any(r.alias_info is None for r in returns))
    return traits


@dataclasses.dataclass
class StepCount:
    """What :class:`StepCounter` counted, one entry per device of
    ``devices`` (bytes and FLOPs as Python numbers)."""

    devices: Tuple[str, ...]
    argument_bytes: List[int]
    output_bytes: List[int]
    peak_bytes: List[int]
    flops: List[float]
    bytes_accessed: List[float]
    #: {(source index, destination index, kind): [bytes, copies]}
    copies: Dict[Tuple[int, int, str], List[int]]
    #: {kernel name: calls served by its shape-only route}
    kernels: Dict[str, int]
    seconds: float = 0.0

    @property
    def temp_bytes(self) -> List[int]:
        return [p - a for p, a in zip(self.peak_bytes, self.argument_bytes)]


class StepCounter(TorchDispatchMode):
    """Counts per device of ``devices`` (a mesh's) while it is entered;
    :meth:`track_arguments` before the step, :meth:`track_outputs`
    after it, :meth:`result` to read.  A device outside ``devices`` (the
    CPU holding a scalar, an index-less ``meta``) is not counted."""

    def __init__(self, devices: Sequence):
        super().__init__()
        self.devices = tuple(torch.device(d) for d in devices)
        self._index = {d: i for i, d in enumerate(self.devices)}
        n = len(self.devices)
        self.flops = [0.0] * n
        self.bytes_accessed = [0.0] * n
        self.live = [0] * n
        self.peak = [0] * n
        self.argument_bytes = [0] * n
        self.output_bytes = [0] * n
        self.copies: Dict[Tuple[int, int, str], List[int]] = \
            collections.defaultdict(lambda: [0, 0])
        self.kernels: Dict[str, int] = collections.Counter()
        self._held: Dict[int, int] = {}   # id(storage) -> device index
        # a real backward runs on the autograd engine's device threads
        self._lock = threading.RLock()

    # -- storages ---------------------------------------------------------

    def _device_of(self, t: torch.Tensor):
        """The mesh index of ``t``'s device, or None off the mesh."""
        dev = t.device
        return self._index[dev] if dev in self._index else None

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now on (once), if ``t``
        lies on the mesh."""
        d = self._device_of(t)
        st = t.untyped_storage()
        key = id(st)
        if d is None or key in self._held:
            return
        n = st.nbytes()
        self._held[key] = d
        self.live[d] += n
        self.peak[d] = max(self.peak[d], self.live[d])
        weakref.finalize(st, self._free, key, d, n)

    def _free(self, key: int, d: int, n: int) -> None:
        with self._lock:
            if self._held.pop(key, None) is not None:
                self.live[d] -= n

    def _storages(self, tree) -> Dict[int, Tuple[int, int]]:
        """{id(storage): (device index, bytes)} of the tensors of
        ``tree`` on the mesh (``models/sharding.py::Sharded`` leaves
        read shard by shard)."""
        out = {}
        for t in _leaf_tensors(tree):
            if t.device in self._index:
                st = t.untyped_storage()
                out[id(st)] = (self._index[t.device], st.nbytes())
        return out

    def track_arguments(self, args) -> None:
        """The step's arguments: their storages are live from the start
        and make up each device's argument bytes."""
        for t in _leaf_tensors(args):
            self._track(t)
        for d, n in self._storages(args).values():
            self.argument_bytes[d] += n

    def track_outputs(self, out) -> None:
        """The step's results: each device's storages among them, once
        each (an output written in place into an argument counts too)."""
        for d, n in self._storages(out).values():
            self.output_bytes[d] += n

    # -- kernels ----------------------------------------------------------

    def kernel_work(self, name: str, device, ops: float,
                    nbytes: float) -> None:
        """A kernel call served by a shape-only route: its operations and
        the bytes it reads and writes, on ``device``."""
        d = self._index.get(torch.device(device))
        with self._lock:
            self.kernels[name] += 1
            if d is not None:
                self.flops[d] += ops
                self.bytes_accessed[d] += nbytes

    # -- dispatch ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if outs:
            self._tally(func, args, kwargs, out, outs)
        return out

    def _tally(self, func, args, kwargs, out, outs) -> None:
        # work out the op's counts first; hold the lock only to add them
        moves, allocates = _traits(func)
        at = self._device_of
        traffic = ([(at(t), _nbytes(t)) for t in _tensors((args, kwargs))
                    + outs] if moves else [])
        packet = func._overloadpacket
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        copy = None
        if func in _COPIES:
            src, dst = ((args[0], out) if func is _aten._to_copy.default
                        else (args[1], args[0]))
            s, t = at(src), at(dst)
            if s is not None and t is not None and s != t:
                copy = (s, t, collective_kind() or "other"), _nbytes(src)
        d_out = at(outs[0])
        with self._lock:
            for d, n in traffic:
                if d is not None:
                    self.bytes_accessed[d] += n
            if allocates:
                for t in outs:
                    self._track(t)
            if flops and d_out is not None:
                self.flops[d_out] += flops
            if copy is not None:
                entry = self.copies[copy[0]]
                entry[0] += copy[1]
                entry[1] += 1

    def result(self, seconds: float = 0.0) -> StepCount:
        return StepCount(
            devices=tuple(str(d) for d in self.devices),
            argument_bytes=list(self.argument_bytes),
            output_bytes=list(self.output_bytes), peak_bytes=list(self.peak),
            flops=list(self.flops), bytes_accessed=list(self.bytes_accessed),
            copies={k: list(v) for k, v in self.copies.items()},
            kernels=dict(self.kernels), seconds=seconds)


def kernel_work(name: str, device, ops: float, nbytes: float) -> None:
    """Hand a shape-only kernel call's work to every :class:`StepCounter`
    on the calling thread's mode stack."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, StepCounter):
            mode.kernel_work(name, device, ops, nbytes)
