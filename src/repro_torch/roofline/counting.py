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

A plain function whose op-by-op run on fake tensors costs the dry run
most of its host time takes :func:`counted_call`: the blocked attention
(``models/attention.py::blocked_attention``, a Python double loop over
blocks, differentiated in training), the SSD scan
(``models/mamba.py::_ssd_chunked``, a loop over chunks) and each layer
of a mesh's training loss (``models/transformer.py::checkpoint_tp``,
repeated layer after layer and microbatch after microbatch).  Its
op-by-op count is taken once per signature (:func:`count_call`: on
``meta`` tensors, or on fake tensors of its devices where it spans
several), and every call with that signature replays it through one
autograd node, :class:`_Replay`: the same FLOPs, bytes and copies
between devices, the same peaks, the same bytes kept for the backward
pass, outputs and gradients of the same layout.  Two departures are
known: a call inside ``torch.utils.checkpoint`` whose outputs feed no
op that saves a tensor is recomputed whole, where checkpoint's early
stop cuts the op-by-op recomputation short; and storages that only an
output dropped unused keeps for the backward pass (the SSD scan's final
state in training) stay live until the backward, where op by op they
go with the output.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
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
    #: {function name: calls replayed by :func:`counted_call`}
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    #: per device, {(op, dtype, shape): bytes} live at its peak
    peak_by_op: List[Dict[tuple, int]] = dataclasses.field(
        default_factory=list)

    @property
    def temp_bytes(self) -> List[int]:
        return [p - a for p, a in zip(self.peak_bytes, self.argument_bytes)]


class StepCounter(TorchDispatchMode):
    """Counts per device of ``devices`` (a mesh's) while it is entered;
    :meth:`track_arguments` before the step, :meth:`track_outputs`
    after it, :meth:`result` to read.  A device outside ``devices`` (the
    CPU holding a scalar, an index-less ``meta``) is not counted; a
    device that ``devices`` repeats (a mesh laid over one card) is
    counted once.

    It also keeps, per device, what was live at the peak: bytes by (the
    op that allocated the storage, its dtype, its shape), in
    :attr:`peak_by_op` (the step's arguments under ``arguments``, a
    replayed call's bytes under its name)."""

    def __init__(self, devices: Sequence):
        super().__init__()
        self.devices = tuple(dict.fromkeys(torch.device(d) for d in devices))
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
        self.routes: Dict[str, int] = collections.Counter()
        self._held: Dict[int, int] = {}   # id(storage) -> device index
        self._made: Dict[int, tuple] = {}   # id(storage) -> its group
        self._live_by = [collections.Counter() for _ in range(n)]
        #: per device, {(op, dtype, shape): bytes} live at the peak
        self.peak_by_op: List[Dict[tuple, int]] = [{} for _ in range(n)]
        # per device: live is at a new peak that no free has ended yet
        self._at_peak = [False] * n
        # a real backward runs on the autograd engine's device threads
        self._lock = threading.RLock()

    # -- storages ---------------------------------------------------------

    def _device_of(self, t: torch.Tensor):
        """The mesh index of ``t``'s device, or None off the mesh."""
        dev = t.device
        return self._index[dev] if dev in self._index else None

    def _track(self, t: torch.Tensor, op: str = "arguments") -> None:
        """Count ``t``'s storage as live from now on (once), if ``t``
        lies on the mesh; ``op`` made it."""
        d = self._device_of(t)
        st = t.untyped_storage()
        key = id(st)
        if d is None or key in self._held:
            return
        n = st.nbytes()
        self._held[key] = d
        self.live[d] += n
        group = (getattr(_LABEL, "name", None) or op, t.dtype, t.shape)
        self._made[key] = group
        live = self._live_by[d]
        live[group] += n
        if self.live[d] > self.peak[d]:
            self.peak[d] = self.live[d]
            self._at_peak[d] = True
        weakref.finalize(st, self._free, key, d, n)

    def _free(self, key: int, d: int, n: int) -> None:
        with self._lock:
            if self._held.pop(key, None) is not None:
                self._leave_peak(d)
                self.live[d] -= n
                group = self._made.pop(key)
                live = self._live_by[d]
                live[group] -= n
                if not live[group]:
                    del live[group]

    def _leave_peak(self, d: int) -> None:
        """Keep what device ``d`` holds as its peak's, if it is at one:
        the first free after a new peak ends it."""
        if self._at_peak[d]:
            self.peak_by_op[d] = dict(self._live_by[d])
            self._at_peak[d] = False

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

    def call_work(self, name: str, phase, device) -> None:
        """One :class:`Phase` (forward or backward) of a call that
        :func:`counted_call` replays: its FLOPs, bytes and copies, by
        device (the phase's unnamed device is ``device``)."""
        def at(dev):
            return self._index.get(torch.device(dev or device))
        # work out the indices first; hold the lock only to add them
        flops = [(at(dev), n) for dev, n in phase.flops.items()]
        nbytes = [(at(dev), n) for dev, n in phase.nbytes.items()]
        copies = [((at(src), at(dst), kind), v)
                  for (src, dst, kind), v in phase.copies.items()]
        with self._lock:
            self.routes[name] += 1
            for d, n in flops:
                if d is not None:
                    self.flops[d] += n
            for d, n in nbytes:
                if d is not None:
                    self.bytes_accessed[d] += n
            for key, (n, k) in copies:
                if None not in key[:2]:
                    entry = self.copies[key]
                    entry[0] += n
                    entry[1] += k

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
                    self._track(t, str(packet))
            if flops and d_out is not None:
                self.flops[d_out] += flops
            if copy is not None:
                entry = self.copies[copy[0]]
                entry[0] += copy[1]
                entry[1] += 1

    def result(self, seconds: float = 0.0) -> StepCount:
        with self._lock:
            for d in range(len(self.devices)):
                self._leave_peak(d)
        return StepCount(
            devices=tuple(str(d) for d in self.devices),
            argument_bytes=list(self.argument_bytes),
            output_bytes=list(self.output_bytes), peak_bytes=list(self.peak),
            flops=list(self.flops), bytes_accessed=list(self.bytes_accessed),
            copies={k: list(v) for k, v in self.copies.items()},
            kernels=dict(self.kernels), routes=dict(self.routes),
            seconds=seconds, peak_by_op=[dict(p) for p in self.peak_by_op])


# the name a replayed call's allocations are grouped under
_LABEL = threading.local()


def kernel_work(name: str, device, ops: float, nbytes: float) -> None:
    """Hand a shape-only kernel call's work to every :class:`StepCounter`
    on the calling thread's mode stack."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, StepCounter):
            mode.kernel_work(name, device, ops, nbytes)


# -- counted calls ------------------------------------------------------------

#: a tensor's layout: (size, stride, storage offset, storage bytes, dtype,
#: device).  A count taken on one device names it "" (the call's own):
#: every call of its signature shares it, whatever its device
Layout = Tuple[tuple, tuple, int, int, torch.dtype, str]


def _layout(t: torch.Tensor, device: str) -> Layout:
    return (tuple(t.shape), tuple(t.stride()), t.storage_offset(),
            t.untyped_storage().nbytes(), t.dtype, device)


@dataclasses.dataclass(frozen=True)
class Phase:
    """What one phase of a call (its forward, or a backward) did on each
    device it touched: {device: FLOPs}, {device: bytes accessed}, {device:
    peak bytes over what was live as it began}, and the bytes it copied
    between devices, {(source, destination, kind): [bytes, copies]}."""

    flops: Dict[str, float]
    nbytes: Dict[str, float]
    peak: Dict[str, int]
    copies: Dict[Tuple[str, str, str], List[int]]


@dataclasses.dataclass(frozen=True)
class BackwardCount:
    """The op-by-op count of one call's backward pass, from gradients of
    some of its outputs (:meth:`CallCount.backward`): its phase (each
    output's gradient freed once the node it feeds has run, as the engine
    does) and each input's gradient (None: the input takes none)."""

    phase: Phase
    grads: Tuple[Optional[Layout], ...]


@dataclasses.dataclass
class CallCount:
    """The op-by-op count of one call of a function (:func:`count_call`).
    Per device, ``forward.peak`` is the forward's peak where autograd
    keeps what it saves, ``free_peak`` where saved tensors are dropped at
    once (the first pass of a rematerialized block), ``saved_bytes`` the
    bytes of the storages the forward allocates that autograd keeps for
    the backward pass (the outputs' left out)."""

    forward: Phase
    free_peak: Dict[str, int]
    saved_bytes: Dict[str, int]
    #: the inputs whose own storage autograd keeps
    saved_inputs: Tuple[int, ...]
    outs: Tuple[Layout, ...]
    fn: Callable
    #: (size, stride, dtype, requires grad, device) of each argument (None:
    #: None)
    specs: tuple
    #: the devices the probe counts on
    devices: Tuple[str, ...]
    #: the forward kept for the first backward asked for
    pending: Optional[list] = None
    #: {which outputs take a gradient: that backward's count}
    backwards: Dict[Tuple[bool, ...], BackwardCount] = \
        dataclasses.field(default_factory=dict)

    def backward(self, wanted: Tuple[bool, ...]) -> BackwardCount:
        """The backward from gradients of the outputs ``wanted`` marks
        (an output no later op uses takes none), counted once: the first
        asked for on the forward :func:`count_call` kept, another on a
        forward run anew."""
        got = self.backwards.get(wanted)
        if got is None:
            with _disable_current_modes(), torch.enable_grad():
                state, self.pending = self.pending, None
                if state is None:
                    state = _forward(self.fn, self.specs, self.devices)[1]
                got = self.backwards[wanted] = _backward(state, wanted)
        return got


def _outputs(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


class _Probe:
    """Where :func:`count_call` runs a function: on one device, plain
    ``meta`` tensors (fast; the function must read its device from its
    inputs), the device named "" in the count; on several, fake tensors
    on those very devices under a fake mode of its own.  ``counter``
    counts there, with autograd keeping what it saves (``hooks``; the
    storages it saved in ``saved``)."""

    def __init__(self, devices):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.devices = devices
        self.one = len(devices) == 1
        self.mode = contextlib.nullcontext() if self.one else \
            FakeTensorMode()
        self.counter = StepCounter(["meta"] if self.one else devices)
        self.saved = set()

    def pack(self, t):
        self.saved.add(id(t.untyped_storage()))
        return t

    def device(self, name: str) -> str:
        return "meta" if self.one else name

    def name(self, device) -> str:
        """The count's name of the probe's device ``device``."""
        return "" if self.one else str(device)

    def tensors(self, specs, grad: bool) -> list:
        with self.mode:
            return [None if s is None else torch.empty_strided(
                s[0], s[1], dtype=s[2], device=self.device(s[4]))
                .requires_grad_(grad and s[3]) for s in specs]

    def phase(self, flops, nbytes, peak, copies) -> Phase:
        c = self.counter
        names = [self.name(d) for d in c.devices]
        return Phase(
            {n: c.flops[i] - flops[i] for i, n in enumerate(names)},
            {n: c.bytes_accessed[i] - nbytes[i] for i, n in enumerate(names)},
            {n: c.peak[i] - peak[i] for i, n in enumerate(names)},
            {(names[s], names[t], k): [v[0] - was[0], v[1] - was[1]]
             for (s, t, k), v in c.copies.items()
             for was in [copies.get((s, t, k), [0, 0])] if v != was})

    def mark(self):
        """The counter's totals now, and its peaks restarted from now."""
        c = self.counter
        c.peak[:] = c.live
        return (list(c.flops), list(c.bytes_accessed), list(c.live),
                {k: list(v) for k, v in c.copies.items()})


@contextlib.contextmanager
def _probing(probe: _Probe):
    """Inside ``probe``: its fake mode, its counter, and saved tensors
    kept (and noted)."""
    with probe.mode, probe.counter, torch.autograd.graph.saved_tensors_hooks(
            probe.pack, lambda t: t):
        yield


def _forward(fn: Callable, specs, devices):
    """``fn`` op by op on tensors of ``specs`` in a :class:`_Probe` on
    ``devices``, with autograd keeping its saved tensors: the forward's
    counts, and what :func:`_backward` goes on from (the probe, the
    arguments, the outputs)."""
    probe = _Probe(devices)
    counter = probe.counter
    metas = probe.tensors(specs, torch.is_grad_enabled())
    with _probing(probe):
        counter.track_arguments(metas)
        start = probe.mark()
        base = list(counter.live)
        outs = _outputs(fn(*metas))
        fwd_phase = probe.phase(*start)
        kept = list(counter.live)
        for o in {id(o.untyped_storage()): o for o in outs}.values():
            d = counter._device_of(o)
            if d is not None:
                kept[d] -= o.untyped_storage().nbytes()
    fwd = dict(
        forward=fwd_phase,
        saved_bytes={probe.name(dev): kept[i] - base[i]
                     for i, dev in enumerate(counter.devices)},
        saved_inputs=tuple(i for i, m in enumerate(metas) if m is not None
                           and id(m.untyped_storage()) in probe.saved),
        outs=tuple(_layout(o, probe.name(o.device)) for o in outs))
    return fwd, [probe, metas, list(outs)]


def _backward(state, wanted: Tuple[bool, ...]) -> BackwardCount:
    """The backward of :func:`_forward`'s ``state`` from gradients of the
    outputs ``wanted`` marks, the others dropped first (their graph, and
    what it saved, go with them, as on a real run)."""
    probe, metas, outs = state
    counter = probe.counter
    state.clear()
    inputs = [i for i, m in enumerate(metas)
              if m is not None and m.requires_grad]
    wants = [o for o, w in zip(outs, wanted) if w and o.requires_grad]
    del outs
    with _probing(probe):
        if not (inputs and wants):
            return BackwardCount(probe.phase(*probe.mark()),
                                 (None,) * len(metas))
        gouts = [torch.empty(o.shape, dtype=o.dtype, device=o.device)
                 for o in wants]
        # the engine frees an output's gradient once the node it feeds has
        # run: count it freed from then on
        fed = collections.defaultdict(list)
        for o, g in zip(wants, gouts):
            fed[o.grad_fn].append(g)
        for node, gs in fed.items():
            def ran(grad_inputs, grad_outputs, gs=gs):
                kept = {id(t.untyped_storage()) for t in grad_inputs
                        if t is not None}
                for g in gs:
                    d = counter._device_of(g)
                    if d is not None and id(g.untyped_storage()) not in kept:
                        counter.live[d] -= _nbytes(g)
            node.register_hook(ran)
        start = probe.mark()
        grads = torch.autograd.grad(wants, [metas[i] for i in inputs],
                                    gouts, allow_unused=True)
        layouts = [None] * len(metas)
        for i, g in zip(inputs, grads):
            layouts[i] = None if g is None else \
                _layout(g, probe.name(g.device))
        return BackwardCount(probe.phase(*start), tuple(layouts))


def count_call(fn: Callable, args: Sequence, devices=None) -> CallCount:
    """Run ``fn(*args)`` op by op on tensors of ``args``' layouts (None
    entries stay None) with the current grad mode, each time under a
    :class:`StepCounter` of its own, and return its count: the forward
    where autograd keeps its saved tensors, again where it drops them,
    and, if the call is differentiated, the backward from gradients of
    its output if it has one (a backward from some of several outputs is
    counted when asked for, :meth:`CallCount.backward`).  ``devices``:
    the devices to count on, at least those of ``args`` (their own by
    default); one device runs on plain meta tensors, several on fake
    tensors on those devices.  ``fn`` must be pure: it reads its
    arguments and returns new tensors.  The dispatch modes of the caller
    (a fake mode, its counters) are set aside while it runs."""
    own = tuple(dict.fromkeys(str(a.device) for a in args if a is not None))
    devices = tuple(devices or own)
    specs = tuple(None if a is None else (tuple(a.shape), tuple(a.stride()),
                                          a.dtype, a.requires_grad,
                                          str(a.device)) for a in args)
    grad = torch.is_grad_enabled() and any(a is not None and a.requires_grad
                                           for a in args)
    with _disable_current_modes(), torch.set_grad_enabled(grad):
        fwd, state = _forward(fn, specs, devices)
        free_peak = fwd["forward"].peak
        # dropping saved tensors changes nothing where none was allocated
        # by the call (a rematerialized block saves only its inputs)
        if grad and any(fwd["saved_bytes"].values()):
            probe = _Probe(devices)
            metas = probe.tensors(specs, grad)
            with probe.mode, probe.counter, \
                    torch.autograd.graph.saved_tensors_hooks(
                        lambda t: None, lambda t: None):
                probe.counter.track_arguments(metas)
                start = probe.mark()
                fn(*metas)
                free_peak = probe.phase(*start).peak
        count = CallCount(free_peak=free_peak, fn=fn, specs=specs,
                          devices=devices, pending=state if grad else None,
                          **fwd)
        if grad and len(count.outs) == 1:
            # one output: its backward is the one asked for
            count.backward((True,))
    return count


def _allocate(layout: Layout, where) -> torch.Tensor:
    """A tensor of ``layout`` (its device "" being ``where``): its storage
    as large as the layout's (a view of a larger one only where the
    layout's is larger than its strides reach), its strides the
    layout's."""
    size, stride, offset, nbytes, dtype, device = layout
    device = device or where
    reach = 0 if 0 in size else 1 + sum((n - 1) * s
                                        for n, s in zip(size, stride))
    if not offset and reach * dtype.itemsize == nbytes:
        return torch.empty_strided(size, stride, dtype=dtype, device=device)
    base = torch.empty(nbytes // dtype.itemsize, dtype=dtype, device=device)
    return base.as_strided(size, stride, offset)


def _transients(peaks: Dict[str, int], where, less=None) -> None:
    """Raise each device's live bytes (device "" being ``where``) by its
    ``peaks`` entry, less its ``less`` entry, for a moment."""
    for device, n in peaks.items():
        n -= (less or {}).get(device, 0)
        if n > 0:
            torch.empty(n, dtype=torch.uint8, device=device or where)


@contextlib.contextmanager
def _labelled(name: str):
    """Group what is allocated inside under ``name``."""
    was, _LABEL.name = getattr(_LABEL, "name", None), name
    try:
        yield
    finally:
        _LABEL.name = was


def _counters() -> list:
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, StepCounter)]


class _Replay(torch.autograd.Function):
    """One call that :func:`counted_call` replays from its
    :class:`CallCount`.  On each device the forward's live bytes rise to
    the count's ``free_peak``, then the saved bytes are allocated and
    saved (kept, or dropped at once by a rematerialized block's hooks, as
    the op-by-op path's would be), then the live bytes rise to the
    forward's peak, then the outputs are allocated: either way the peak
    and what is left are the op-by-op path's.  The backward unpacks the
    saved bytes (a checkpointed block recomputes then), rises by the
    peak of the backward from the outputs that got a gradient, and
    returns gradients of the op-by-op layout."""

    @staticmethod
    def forward(ctx, name, count, *args):
        where = next(str(a.device) for a in args if a is not None)
        ctx.name, ctx.count, ctx.where = name, count, where
        ctx.set_materialize_grads(False)
        for counter in _counters():
            counter.call_work(name, count.forward, where)
        with _labelled(f"{name} (working)"):
            _transients(count.free_peak, where)
        with _labelled(f"{name} (saved)"):
            saved = [torch.empty(n, dtype=torch.uint8,
                                 device=device or where)
                     for device, n in count.saved_bytes.items() if n > 0]
        ctx.save_for_backward(*saved,
                              *[args[i] for i in count.saved_inputs])
        del saved
        with _labelled(f"{name} (working)"):
            _transients(count.forward.peak, where, count.saved_bytes)
        with _labelled(f"{name} (output)"):
            outs = tuple(_allocate(o, where) for o in count.outs)
        for o in outs:
            if not o.dtype.is_floating_point:
                ctx.mark_non_differentiable(o)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # noqa: B018 -- a checkpointed block recomputes
        bwd = ctx.count.backward(tuple(g is not None for g in grads))
        for counter in _counters():
            counter.call_work(ctx.name, bwd.phase, ctx.where)
        with _labelled(f"{ctx.name} (working)"):
            _transients(bwd.phase.peak, ctx.where)
        with _labelled(f"{ctx.name} (gradients)"):
            return (None, None, *[
                None if g is None or not ctx.needs_input_grad[2 + i]
                else _allocate(g, ctx.where)
                for i, g in enumerate(bwd.grads)])


_COUNTS: Dict[tuple, CallCount] = {}
# process-wide: a backward may run on the autograd engine's threads
_op_by_op = False


@contextlib.contextmanager
def op_by_op():
    """Inside, :func:`counted_call` runs its function op by op on the
    fake tensors, as the dry run did before it replayed: the yardstick
    its replays are held to.  Process-wide, as a backward pass may run
    on the autograd engine's threads."""
    global _op_by_op
    was, _op_by_op = _op_by_op, True
    try:
        yield
    finally:
        _op_by_op = was


def counted_call(name: str, fn: Callable, args: Sequence, key=()):
    """``fn(*args)`` for fake ``args`` (None entries allowed), without
    running it: the op-by-op count of ``fn`` on this signature (the
    args' layouts and devices, which require grad, the grad mode, and
    ``key``, the hashable static arguments ``fn`` closes over) is taken
    once (with ``key`` None, for this call alone; :func:`count_call`, on
    the devices of the :class:`StepCounter` counting the call where it
    spans several) and replayed (:class:`_Replay`).  Returns ``fn``'s
    output (a tensor, or a tuple of them) as empty tensors of its
    layout.  ``fn`` reads tensors from its arguments only (a tensor it
    closes over would outlive the call in the count, and the count is
    taken on other tensors).  Under
    :func:`op_by_op`, or where no counter counts, ``fn(*args)`` itself."""
    counters = _counters()
    if _op_by_op or not counters:
        return fn(*args)
    grad = torch.is_grad_enabled()
    own = tuple(dict.fromkeys(str(a.device) for a in args if a is not None))
    # a one-device count serves a call on any device
    devices = own if len(own) == 1 else tuple(map(str, counters[0].devices))
    sig = (name, key, grad, len(own) > 1 and devices, tuple(
        None if a is None else (tuple(a.shape), tuple(a.stride()), a.dtype,
                                a.requires_grad,
                                len(own) > 1 and str(a.device))
        for a in args))
    count = None if key is None else _COUNTS.get(sig)
    if count is None:
        count = count_call(fn, args, devices)
        if key is not None:
            _COUNTS[sig] = count
    outs = _Replay.apply(name, count, *args)
    return outs if len(outs) > 1 else outs[0]
