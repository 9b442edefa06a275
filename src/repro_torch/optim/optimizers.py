"""Optimizers, schedules and gradient transforms over parameter trees.

Port of the JAX package's ``optim/optimizers.py``.  An ``Optimizer`` is
a pair of functions over the port's parameter trees (dicts, lists and
tuples of tensors, :mod:`repro_torch.tree`):

  init(params)                           -> opt_state
  update(grads, opt_state, params, step) -> (new_params, new_opt_state)

Optimizer state mirrors the parameter tree; ``state_dtype`` sets the
moments' dtype (bf16 moments for the very large configs, as in the JAX
package).

The update writes each new value into the storage of the parameter and
moment it replaces, one leaf at a time under ``torch.no_grad()``, and
returns the trees it was given: they are donated, as a jitted JAX step
donates its buffers.  So an update's transient memory is a few copies
of the largest leaf in f32, never a second copy of the model and its
moments.  The arithmetic is the reference's, expression
for expression; learning rates, schedules and bias corrections are
float32 tensors computed from the step in float32 (``step.astype(f32)``
there), not Python doubles.

Sharded trees (``models/sharding.py::Sharded`` leaves, a tree placed on
a mesh's devices): every shard is updated in place on its own device
with the same expressions, so an element's update is bit for bit the
single-device one given the same gradient and clip scale.
:func:`global_norm` sums each device's owned shards in f32 on that
device, then adds the partial sums on the first device in device order
(no float atomics); the clip scale is copied to every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.sharding import Sharded
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _pieces(x) -> list:
    """The tensors a leaf holds: a :class:`Sharded` leaf's shards, one
    per device, else the leaf itself."""
    return x.shards if isinstance(x, Sharded) else [x]


def _flat_pieces(tree) -> list:
    """Every tensor of ``tree``: the leaves in order, a sharded leaf's
    shards in device order."""
    return [x for leaf in leaves(tree) for x in _pieces(leaf)]


def _leafwise(fn):
    """``fn`` over a leaf's tensors, in a leaf of the same layout."""
    return lambda x: x.map(fn) if isinstance(x, Sharded) else fn(x)


def _per_device(*scalars):
    """``on(device)``: the scalar tensors copied to ``device``, once a
    device (a CPU scalar serves any device as it is)."""
    cache = {}

    def on(device):
        if device not in cache:
            cache[device] = tuple(
                t if t.device.type == "cpu" or t.device == device
                else t.to(device) for t in scalars)
        return cache[device]
    return on


def _f32(step) -> torch.Tensor:
    """The step as a float32 scalar tensor (an int stays on the CPU)."""
    if torch.is_tensor(step):
        return step.detach().to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


# -- schedules ----------------------------------------------------------------

def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, max=1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        s = _f32(step)
        warm = lr * (s + 1) / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(s - warmup))
    return f


# -- gradient transforms ------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.

    Over a sharded tree, device d's partial sum covers the shards it
    owns (``Sharded.owner``: each chunk counted once, on its first
    holder), in leaf order on device d; the partials are added on the
    first device in device order.  One device: the sum of the leaves in
    leaf order.
    """
    flat = leaves(tree)
    ndev = max((len(_pieces(x)) for x in flat), default=1)
    partials = []
    for d in range(ndev):
        owned = [x.shards[d] if isinstance(x, Sharded) else x for x in flat
                 if (x.owner(d) == d if isinstance(x, Sharded) else d == 0)]
        if owned:
            partials.append(sum(torch.sum(torch.square(x.float()))
                                for x in owned))
    total = partials[0]
    for part in partials[1:]:
        total = total + part.to(total.device)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``.

    The leaves are scaled in place (the train step owns its gradient
    accumulator, and an f32 copy of gemma-2b's gradients is 10 GB).
    Returns ``(grads, norm before clipping)``.
    """
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        on = _per_device(scale)
        for g in _flat_pieces(grads):
            g.mul_(on(g.device)[0].to(g.dtype))
    return grads, norm


# -- optimizers ---------------------------------------------------------------

def sgd(lr, momentum: float = 0.0, nesterov: bool = False):
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(_leafwise(torch.zeros_like), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        on = _per_device(lr_fn(step))
        flat_p, flat_g = _flat_pieces(params), _flat_pieces(grads)
        flat_m = (_flat_pieces(state["mu"]) if momentum
                  else [None] * len(flat_p))
        for p, g, m in zip(flat_p, flat_g, flat_m):
            (lr_t,) = on(p.device)
            if m is None:
                u = g
            else:
                m.copy_(momentum * m + g.to(m.dtype))
                u = momentum * m + g.to(m.dtype) if nesterov else m
            p.copy_(p - (lr_t * u.float()).to(p.dtype))
        return params, state

    return Optimizer(init, update)


# elements of a slice of the Adam update: its float32 temporaries (half
# a dozen at once) stay a few hundred MB where a whole leaf's would not
# fit beside the state (deepseek-v3's experts at (1, 4): 0.94e9 entries
# a card, 3.76 GB a temporary)
_UPDATE_SLICE = 1 << 26


def row_slices(*ts):
    """Matching slices along dim 0 of tensors of one shape, each of at
    most ``_UPDATE_SLICE`` elements where the rows allow (views: an
    in-place write lands in the tensor).  An elementwise update applied
    slice by slice is the whole update, bit for bit."""
    n = ts[0].numel()
    if ts[0].dim() == 0 or n <= _UPDATE_SLICE:
        return [ts]
    rows = max(1, _UPDATE_SLICE * ts[0].shape[0] // n)
    return list(zip(*(t.split(rows) for t in ts)))


def _adam_core(lr, b1, b2, eps, weight_decay, state_dtype):
    lr_fn = lr if callable(lr) else constant_schedule(lr)
    sdt = getattr(torch, state_dtype) if isinstance(state_dtype, str) \
        else state_dtype

    def init(params):
        @_leafwise
        def zeros(p):
            return torch.zeros(p.shape, dtype=sdt, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        s = _f32(step)
        on = _per_device(lr_fn(step), 1 - torch.pow(b1, s + 1),
                         1 - torch.pow(b2, s + 1))
        for p, g, m, v in (piece for leaf in zip(
                _flat_pieces(params), _flat_pieces(grads),
                _flat_pieces(state["m"]), _flat_pieces(state["v"]))
                for piece in row_slices(*leaf)):
            lr_t, c1, c2 = on(p.device)
            g32 = g.float()
            m_new = b1 * m.float() + (1 - b1) * g32
            v_new = b2 * v.float() + (1 - b2) * torch.square(g32)
            delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, state

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         state_dtype="float32"):
    return _adam_core(lr, b1, b2, eps, 0.0, state_dtype)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype="float32"):
    return _adam_core(lr, b1, b2, eps, weight_decay, state_dtype)
