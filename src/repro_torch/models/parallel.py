"""Tensor-parallel collectives over the ``model`` ranks of one replica.

The port drives a mesh from one Python process (``launch/mesh.py``).
Under tensor parallelism the M devices of a replica are its ranks: rank
j holds its slice of each projection that ``models/sharding.py``'s rules
cut over ``model``, and a layer runs as a list of M per-rank tensors,
rank j's on device j, computed rank after rank between the collectives
below.  Under GSPMD the compiler inserts them, so this module has no
JAX counterpart.

The collectives are differentiable functions of that list.  A sum adds
the ranks' tensors in rank order on the first rank's device and copies
the result out, and every backward pass sums its gradients in rank order
too: a run is deterministic and needs no float atomics and no
``torch.distributed`` (NCCL refuses two ranks on one card, and the CPU
tests run ``("cpu",) * M``).  :func:`reduce_to` and :func:`broadcast_to`
are the same two moves between any devices of a mesh: the MoE layer's
expert-parallel exchange over the data axis is built of them
(``models/moe.py::moe_apply_mesh``).  Serving adds two more:
:meth:`Group.heads_to_seq` moves a prompt's K/V from the ranks that
projected their heads to the ranks whose slices of the cache's sequence
hold them, and :meth:`Group.lse_combine` combines the ranks' partial
softmaxes of a decode step (flash-decode) in rank order.

A dimension is held in column spans ``(lo, hi)``: a leaf cut over
``model`` holds block j on rank j (:func:`held`); a leaf whose cut the
divisibility check dropped holds the whole dimension on every rank, and
then rank 0 alone computes with it (:func:`work`).  A rank with no work
gives ``None`` in a list.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

Span = Optional[Tuple[int, int]]


def held(j: int, ranks: int, n_local: int, n: int) -> Tuple[int, int]:
    """The span of a dimension of size ``n`` that rank j's slice of
    ``n_local`` entries holds: block j when the dimension is cut, else
    all of it."""
    if n_local == n:
        return 0, n
    if n_local * ranks != n:
        raise ValueError(f"{n_local} entries of {n} are neither the whole "
                         f"dimension nor one of {ranks} blocks")
    return j * n_local, (j + 1) * n_local


def work(j: int, ranks: int, n_local: int, n: int) -> Span:
    """The span of a dimension rank j computes: its block of a cut
    dimension; of a whole one, all of it on rank 0 and nothing
    elsewhere."""
    if n_local == n:
        return (0, n) if j == 0 else None
    return held(j, ranks, n_local, n)


class _Broadcast(torch.autograd.Function):
    """One tensor copied to every rank's device; the backward sums the
    copies' gradients in rank order on the source's device."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.set_materialize_grads(False)
        ctx.device = x.device
        return tuple(x.to(dev, copy=True) for dev in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                g = g.to(ctx.device)
                total = g if total is None else total + g
        return total, None


def reduce_to(xs: Sequence, device) -> Optional[torch.Tensor]:
    """Σ xs on ``device``, added in list order (``None`` entries
    skipped; None if every entry is).  The backward pass copies the
    sum's gradient to each term's device: no sum."""
    total = None
    for x in xs:
        if x is not None:
            x = x.to(device)
            total = x if total is None else total + x
    return total


def broadcast_to(x: torch.Tensor, devices: Sequence) -> list:
    """A copy of ``x`` on each of ``devices`` (in that order); the
    backward pass sums the copies' gradients in that order on ``x``'s
    device."""
    return list(_Broadcast.apply(x, tuple(torch.device(d)
                                          for d in devices)))


class _Redistribute(torch.autograd.Function):
    """Column spans moved between ranks: output j is the concatenation
    of ``plan[j]``'s pieces ``(source, lo, hi)``; the backward adds each
    piece's gradient back into its source in rank order."""

    @staticmethod
    def forward(ctx, plan, have, dim, devices, *xs):
        ctx.set_materialize_grads(False)
        ctx.plan, ctx.have, ctx.dim = plan, have, dim
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(torch.cat([
            xs[k].narrow(dim, lo - have[k][0], hi - lo).to(devices[j])
            for k, lo, hi in pieces], dim)
            for j, pieces in enumerate(plan) if pieces)

    @staticmethod
    def backward(ctx, *grads):
        plan, have, dim = ctx.plan, ctx.have, ctx.dim
        out: List[Optional[torch.Tensor]] = [None] * len(ctx.shapes)
        wanted = [pieces for pieces in plan if pieces]
        for pieces, g in zip(wanted, grads):
            if g is None:
                continue
            at = 0
            for k, lo, hi in pieces:
                shape, dtype, device = ctx.shapes[k]
                if out[k] is None:
                    out[k] = torch.zeros(shape, dtype=dtype, device=device)
                out[k].narrow(dim, lo - have[k][0], hi - lo).add_(
                    g.narrow(dim, at, hi - lo).to(device))
                at += hi - lo
        return (None, None, None, None, *out)


class Group:
    """The M ranks of one replica: ``devices[j]`` is rank j's device (a
    group may repeat a device)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def reduce(self, xs: Sequence) -> torch.Tensor:
        """Σ_j xs[j] on rank 0's device, added in rank order (``None``
        entries skipped)."""
        return reduce_to(xs, self.devices[0])

    def broadcast(self, x: torch.Tensor) -> list:
        """A copy of ``x`` on every rank's device."""
        return broadcast_to(x, self.devices)

    def all_reduce(self, xs: Sequence) -> list:
        """Σ_j xs[j], added in rank order, copied to every rank."""
        return self.broadcast(self.reduce(xs))

    def all_max(self, xs: Sequence) -> list:
        """The elementwise max of the ranks' tensors, on each rank that
        gave one (``None`` elsewhere); not differentiated (a shift that
        keeps ``exp`` in range)."""
        with torch.no_grad():
            top = None
            for x in xs:
                if x is not None:
                    x = x.to(self.devices[0])
                    top = x if top is None else torch.maximum(top, x)
            return [None if x is None else top.to(x.device, copy=True)
                    for x in xs]

    def redistribute(self, xs: Sequence, have: Sequence[Span],
                     want: Sequence[Span], dim: int = -1) -> list:
        """Rank j's span ``want[j]`` of a dimension whose span
        ``have[k]`` rank k holds in ``xs[k]``: a slice of its own tensor
        where that covers it, else the pieces concatenated from the
        ranks that hold them (its own first, then in rank order).
        ``None`` where ``want[j]`` is None."""
        ndim = next(x.dim() for x in xs if x is not None)
        dim %= ndim
        if all(w is None or (xs[j] is not None and have[j][0] <= w[0]
                             and w[1] <= have[j][1])
               for j, w in enumerate(want)):
            return [None if w is None else
                    xs[j].narrow(dim, w[0] - have[j][0], w[1] - w[0])
                    for j, w in enumerate(want)]
        plan = []
        for j, w in enumerate(want):
            pieces = []
            lo = None if w is None else w[0]
            order = [j] + [k for k in range(len(xs)) if k != j]
            while w is not None and lo < w[1]:
                k = next((k for k in order if xs[k] is not None
                          and have[k][0] <= lo < have[k][1]), None)
                if k is None:
                    raise ValueError(f"no rank holds column {lo}")
                hi = min(w[1], have[k][1])
                pieces.append((k, lo, hi))
                lo = hi
            plan.append(pieces)
        srcs = [x if x is not None else torch.empty(0) for x in xs]
        outs = iter(_Redistribute.apply(plan, list(have), dim,
                                        self.devices, *srcs))
        return [next(outs) if pieces else None for pieces in plan]

    def heads_to_seq(self, xs: Sequence, have: Sequence[Span],
                     seq: Sequence[Span], heads: Sequence[Span]) -> list:
        """Rank j's block of a (B, S, K, dh) tensor held split by heads:
        rows ``seq[j]`` of the sequence and heads ``heads[j]``, where rank
        k holds heads ``have[k]`` of every row in ``xs[k]``.  A pure copy,
        the pieces taken in rank order (a rank's own first); ``None``
        where ``seq[j]`` or ``heads[j]`` is None or the rows are empty.
        The serving prefill moves a prompt's K/V this way from the ranks
        that projected them to the ranks whose cache slices hold them."""
        out = []
        for j, (rows, want) in enumerate(zip(seq, heads)):
            if rows is None or want is None or rows[0] >= rows[1]:
                out.append(None)
                continue
            parts = [None if x is None else x.narrow(1, rows[0],
                                                     rows[1] - rows[0])
                     for x in xs]
            wants: List[Span] = [None] * self.size
            wants[j] = want
            out.append(self.redistribute(parts, have, wants, dim=2)[j])
        return out

    def lse_combine(self, ms: Sequence, ls: Sequence, os: Sequence) -> list:
        """The ranks' partial softmaxes combined in rank order: rank j
        gives, over its own keys, the running max ``ms[j]`` (-inf where
        it saw no key), the sum ``ls[j]`` of ``exp(s - max)`` and the
        unnormalized output ``os[j]`` (one more trailing dimension), or
        ``None`` throughout.  Returns Σ w_j o_j / Σ w_j l_j with w_j =
        exp(m_j - max_k m_k), a weight that is exactly 0 for a rank that
        saw no key, copied to every rank; not differentiated."""
        with torch.no_grad():
            top = self.all_max(ms)
            ws = [None if m is None else torch.where(
                torch.isneginf(m), torch.zeros_like(m), torch.exp(m - t))
                for m, t in zip(ms, top)]
            den = self.reduce([None if w is None else w * lj
                               for w, lj in zip(ws, ls)])
            num = self.reduce([None if w is None else w[..., None] * oj
                               for w, oj in zip(ws, os)])
            return self.broadcast(num / den[..., None])
