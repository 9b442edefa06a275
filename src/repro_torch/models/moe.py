"""Mixture-of-Experts FFN with sort-based token-choice dispatch.

Port of the JAX package's ``models/moe.py``: token-choice top-k routing
with renormalized gates, optional always-on shared experts, and the
sort-based (MegaBlocks-style) dispatch:

  1. flatten the top-k assignments and sort them by expert id (stable),
  2. each row's rank within its expert from the sorted ids,
  3. scatter the rows into an (E, C, d) buffer (rows past capacity C
     drop into a discarded slot),
  4. grouped expert GEMMs (E, C, d) x (E, d, ff) as batched matmuls,
  5. gather back through the inverse permutation, weight by the gates,
     sum the k copies.

The JAX package computes the expert GEMMs with ``jnp.einsum`` outside
any Pallas kernel, so here they are ``torch.bmm``.  Its data-parallel
``vmap`` over token shards is a constant 1 and its ``constrain`` calls
are TPU sharding hints: neither has a counterpart.

Under a data x model mesh, :func:`moe_apply_mesh` routes the tokens of
all replicas at once, as the JAX package routes a microbatch's whole
batch (its ``_num_data_shards`` is 1): the capacity, each row's rank
within its expert and the aux metrics are the whole microbatch's.  Each
replica routes its own rows; a row's global rank within its expert is
the rows of that expert in the replicas before it plus its local rank.
The replicas' rows are contiguous blocks of the microbatch in replica
order (``sharding.batch_rows``), so that is the rank the JAX package's
stable sort of all rows gives.  Expert parallelism follows the rules
``"F.m"`` and ``"Fm."``: replica r holds the experts of chunk r mod P
(P the chunks the data axes cut the experts into) with the expert-ff
dim over its ``model`` ranks.  Each source replica scatters its kept
rows into a buffer of its own with the global slots, the P blocks of
experts go to their owners (whose buffer is the sum of the sources':
the slots are disjoint, so the sum is exact), rank j of an owner runs
the grouped GEMMs with its ff slice, the M partial down-projections are
summed in rank order, and the outputs travel back to every source,
which unsorts, weights and sums its rows as :func:`_moe_shard` does.

Ties: ``lax.top_k`` breaks ties toward the lower expert index and
``jnp.argsort`` is stable; :func:`_top_k` sorts by (probability
descending, index ascending) and the dispatch uses a stable argsort, so
the kept and dropped rows are the JAX package's.  Every routed token
uses capacity, the prompt bucket's pad tokens included, as in the
reference.  The router runs in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import parallel as PL
from repro_torch.models.parallel import work

# capacity is lossless (C = T·k) up to this many expanded rows
_LOSSLESS_ROWS = 4096
# tokens of one dispatch: a longer call whose length it divides is
# routed chunk by chunk, each chunk with its own capacity
_DISPATCH_CHUNK = 8192


def moe_init(gen, cfg, *, device=None):
    """Router (d, E) in float32; experts ``gate``/``up`` (E, d, ff) and
    ``down`` (E, ff, d); shared experts as one MLP ``ff · shared`` wide.
    Each tensor is drawn in float32 and cast, one at a time."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = L.dtype_of(cfg.param_dtype)

    def expert_weights(a, b):
        # scaled in place: one float32 copy of the tensor at a time
        return L._normal(gen, (E, a, b), device).div_(math.sqrt(a)).to(dt)

    p = {"router": {"w": L._normal(gen, (d, E), device) * 0.02},
         "experts": {"gate": expert_weights(d, ff),
                     "up": expert_weights(d, ff),
                     "down": expert_weights(ff, d)}}
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_init(gen, d, ff * cfg.num_shared_experts,
                                 act=cfg.mlp_act, dtype=cfg.param_dtype,
                                 device=device)
    return p


def _capacity(num_tokens: int, cfg) -> int:
    """Expert capacity C: lossless ``T·k`` for small calls (decode steps),
    else ``T·k·capacity_factor / E``."""
    expanded = num_tokens * cfg.experts_per_token
    if expanded <= _LOSSLESS_ROWS:
        return expanded
    cap = int(expanded * cfg.capacity_factor / cfg.num_experts)
    return max(min(cap, expanded), 1)


def _top_k(probs, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, xf, k: int):
    """(logits, probs) (T, E) in float32, the renormalized top-k gates
    ``top_p`` and experts ``top_i`` (T, k) of (T, d) tokens."""
    logits = xf.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)
    return logits, probs, top_p / top_p.sum(-1, keepdim=True), top_i


def _counts(flat_e, E: int):
    """Rows routed to each expert (E,): a scatter-add, as the JAX package
    counts (torch.bincount would wait for the device to size its
    output)."""
    return torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def _plan(flat_e, counts, E: int, C: int, base=None):
    """(order, slot, keep) of the expanded rows ``flat_e`` (their
    experts): the stable sort by expert, each sorted row's place in the
    flattened (E·C) buffer (E·C for a dropped row) and the rows within
    capacity C.  ``base`` (E,): rows of each expert that come before
    these in the global order, so the rank within an expert is global."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[sorted_e]
    if base is not None:
        pos_in_e = pos_in_e + base[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return order, slot, keep


def route(p, xf, cfg):
    """The router and the dispatch plan of (T, d) tokens.

    Returns a dict: ``logits`` and ``probs`` (T, E) in float32, ``top_p``
    (T, k) renormalized gates, ``counts`` (E,) rows routed to each expert,
    ``order`` the stable sort of the T·k expanded rows by expert,
    ``slot`` each sorted row's place in the flattened (E·C) buffer (E·C
    for a dropped row) and ``keep`` the sorted rows within capacity C.
    """
    E, k = cfg.num_experts, cfg.experts_per_token
    logits, probs, top_p, top_i = _router(p, xf, k)
    flat_e = top_i.reshape(-1)
    counts = _counts(flat_e, E)
    order, slot, keep = _plan(flat_e, counts, E,
                              _capacity(xf.shape[0], cfg))
    return dict(logits=logits, probs=probs, top_p=top_p, counts=counts,
                order=order, slot=slot, keep=keep)


def _dispatch(xf, order, slot, keep, k: int, E: int, C: int):
    """The (E, C, d) expert buffer: each kept row of (T, d) tokens at its
    slot, zeros elsewhere."""
    x_sorted = xf[order // k]                                   # (T·k, d)
    buf = xf.new_zeros((E * C + 1, xf.shape[1]))
    buf[slot] = torch.where(keep[:, None], x_sorted,
                            torch.zeros_like(x_sorted))
    return buf[:-1].reshape(E, C, xf.shape[1])


def _combine(y, order, slot, top_p, k: int):
    """The (T, d) output from the experts' (E, C, d) output: each row
    read back from its slot (0 where dropped), unsorted, weighted by its
    gate, the k copies summed."""
    E, C, d = y.shape
    y_flat = torch.cat([y.reshape(E * C, d), y.new_zeros((1, d))])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    out_rows = y_flat[slot][inv] * top_p.reshape(-1).to(y.dtype)[:, None]
    return out_rows.reshape(-1, k, d).sum(1)


def _experts(we, buf, act: str):
    """The grouped expert FFN: (E, C, d) rows through each expert's MLP."""
    cdt = buf.dtype
    if act in ("swiglu", "geglu"):
        fn = F.silu if act == "swiglu" else L._gelu
        h = fn(torch.bmm(buf, we["gate"].to(cdt)))
        h = h * torch.bmm(buf, we["up"].to(cdt))
    else:
        h = L._gelu(torch.bmm(buf, we["up"].to(cdt)))
    return torch.bmm(h, we["down"].to(cdt))


def _moe_shard(p, xf, cfg):
    """Dispatch, expert GEMMs and combine for (T, d) tokens; returns
    ``(out (T, d), metrics)``."""
    T = xf.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    r = route(p, xf, cfg)
    C = _capacity(T, cfg)

    # switch-style load balance and router z-loss
    frac_tokens = r["counts"].float() / (T * k)
    aux_loss = E * torch.sum(frac_tokens * r["probs"].mean(0))
    z_loss = torch.mean(torch.logsumexp(r["logits"], dim=-1) ** 2)

    order, slot, keep = r["order"], r["slot"], r["keep"]
    y = _experts(p["experts"], _dispatch(xf, order, slot, keep, k, E, C),
                 cfg.mlp_act)
    out = _combine(y, order, slot, r["top_p"], k)
    metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "moe_dropped_frac": 1.0 - keep.float().mean()}
    return out, metrics


def _moe_shard_chunked(p, xf, cfg):
    """``_moe_shard`` over chunks of ``_DISPATCH_CHUNK`` tokens when the
    call is longer and divisible by it; metrics are the chunks' means."""
    T = xf.shape[0]
    if T <= _DISPATCH_CHUNK or T % _DISPATCH_CHUNK:
        return _moe_shard(p, xf, cfg)
    outs, metrics = zip(*(_moe_shard(p, xc, cfg)
                          for xc in torch.split(xf, _DISPATCH_CHUNK)))
    return torch.cat(outs), {name: torch.stack([m[name] for m in metrics])
                             .mean() for name in metrics[0]}


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), metrics dict with the aux losses
    and the dropped fraction)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    out, metrics = _moe_shard_chunked(p, xf, cfg)
    if "shared" in p:
        out = out + L.mlp(p["shared"], xf, act=cfg.mlp_act)
    return out.reshape(B, S, d), metrics


# -- the global route over a data x model mesh --------------------------------

def _chunks(sizes):
    """The dispatch chunks of a microbatch whose replicas hold ``sizes``
    tokens each (contiguous, in replica order): for each chunk of
    ``_DISPATCH_CHUNK`` global tokens (the whole microbatch unless it is
    longer and divisible by it, as :func:`_moe_shard_chunked` splits), its
    segments ``(replica, lo, hi)``, the replica's local tokens ``[lo,
    hi)`` in it.  A chunk may span replicas."""
    T = sum(sizes)
    step = T if T <= _DISPATCH_CHUNK or T % _DISPATCH_CHUNK \
        else _DISPATCH_CHUNK
    starts = [sum(sizes[:r]) for r in range(len(sizes))]
    return [[(r, max(lo, s) - s, min(lo + step, s + n) - s)
             for r, (s, n) in enumerate(zip(starts, sizes))
             if s < lo + step and lo < s + n]
            for lo in range(0, T, step)]


def _mesh_chunk(groups, ps, xf, routes, segs, cfg):
    """One dispatch chunk over the mesh: ``segs`` its segments.  Returns
    ({device: its segment's (n, d) output}, metrics on the mesh's first
    device)."""
    R, M = len(groups), groups[0].size
    devs = [dev for g in groups for dev in g.devices]
    E, k = cfg.num_experts, cfg.experts_per_token
    n = sum(hi - lo for _, lo, hi in segs)
    C = _capacity(n, cfg)
    dev0 = devs[0]

    # each segment's rows per expert, and the rows before it in the
    # chunk: the global ranks, in integers
    flat = {r * M + j: routes[r * M + j][3][lo:hi].reshape(-1)
            for r, lo, hi in segs for j in range(M)}
    counts = {d: _counts(f, E) for d, f in flat.items()}
    total = torch.zeros(E, dtype=torch.long, device=dev0)
    plans, bufs = {}, {}
    for r, lo, hi in segs:
        for j in range(M):
            d = r * M + j
            plans[d] = _plan(flat[d], counts[d], E, C, total.to(devs[d]))
            bufs[d] = _dispatch(xf[d][lo:hi], *plans[d], k, E, C)
        total = total + counts[r * M].to(dev0)

    # the experts' owners: replica r holds chunk r mod P of the experts;
    # a source sends each block to the owner in its group of P replicas
    E_l = ps[0]["experts"]["down"].shape[0]
    P = E // E_l
    ff = cfg.moe_d_ff
    sources = [r for r, _, _ in segs]
    back = {}
    for owner in range(R):
        c, group = owner % P, owner // P
        srcs = [r for r in sources if r // P == group]
        if not srcs:
            continue
        partial = []
        for j in range(M):
            d = owner * M + j
            buf = PL.reduce_to([bufs[s * M + j][c * E_l:(c + 1) * E_l]
                                for s in srcs], devs[d])
            we = ps[d]["experts"]
            partial.append(None if work(j, M, we["down"].shape[1], ff)
                           is None else _experts(we, buf, cfg.mlp_act))
        y = groups[owner].reduce(partial)
        copies = PL.broadcast_to(y, [devs[s * M + j] for s in srcs
                                     for j in range(M)])
        for i, s in enumerate(srcs):
            for j in range(M):
                back[(s * M + j, c)] = copies[i * M + j]

    outs = {}
    for r, lo, hi in segs:
        for j in range(M):
            d = r * M + j
            y = torch.cat([back[(d, c)] for c in range(P)])
            outs[d] = _combine(y, plans[d][0], plans[d][1],
                               routes[d][2][lo:hi], k)

    # the switch aux loss, z-loss and dropped share of the whole chunk,
    # from rank 0's route of each replica
    firsts = [(r * M, lo, hi) for r, lo, hi in segs]
    mean_prob = PL.reduce_to([routes[d][1][lo:hi].sum(0)
                              for d, lo, hi in firsts], dev0) / n
    z_sum = PL.reduce_to([(torch.logsumexp(routes[d][0][lo:hi], dim=-1)
                           ** 2).sum() for d, lo, hi in firsts], dev0)
    kept = PL.reduce_to([plans[d][2].sum() for d, _, _ in firsts], dev0)
    metrics = {"moe_aux_loss": E * torch.sum(total.float() / (n * k)
                                             * mean_prob),
               "moe_z_loss": z_sum / n,
               "moe_dropped_frac": 1.0 - kept.float() / (n * k)}
    return outs, metrics


def moe_apply_mesh(groups, ps, xs, cfg):
    """:func:`moe_apply` over a data x model mesh, routed globally.

    ``groups``: the R replicas' :class:`~repro_torch.models.parallel.Group`
    of M ranks each (device d = r·M + j is ``groups[r].devices[j]``);
    ``ps``: each device's MoE parameters (the router whole, its own
    chunk of experts, its slices of the shared experts); ``xs``: each
    device's copy of its replica's (B_r, S, d) input, the replicas'
    rows in microbatch order.  Returns (per-device outputs, metrics on
    the first device): the outputs and metrics of :func:`moe_apply` on
    the whole microbatch, dispatch chunks included (a chunk may span
    replicas; the metrics are the chunks' means).  The shared experts
    run tensor-parallel (``layers.mlp_tp``).
    """
    R, M = len(groups), groups[0].size
    k = cfg.experts_per_token
    xf = [x.reshape(-1, x.shape[-1]) for x in xs]
    routes = [_router(p, x, k) for p, x in zip(ps, xf)]
    outs = [[] for _ in xf]
    ms = []
    for segs in _chunks([xf[r * M].shape[0] for r in range(R)]):
        rows, m = _mesh_chunk(groups, ps, xf, routes, segs, cfg)
        for d, o in rows.items():
            outs[d].append(o)
        ms.append(m)
    # a replica with no rows (a batch every replica holds whole routes
    # from replica 0 alone) gets none back
    out = [o[0] if len(o) == 1 else torch.cat(o) if o else x[:0]
           for o, x in zip(outs, xf)]
    metrics = ms[0] if len(ms) == 1 else {
        name: torch.stack([m[name] for m in ms]).mean() for name in ms[0]}
    if "shared" in ps[0]:
        ff = cfg.moe_d_ff * cfg.num_shared_experts
        for r, group in enumerate(groups):
            ranks = range(r * M, (r + 1) * M)
            shared = L.mlp_tp(group, [ps[d]["shared"] for d in ranks],
                              [xf[d] for d in ranks], ff, cfg.mlp_act)
            for d, o in zip(ranks, shared):
                out[d] = out[d] + o
    return [o.reshape(x.shape) for o, x in zip(out, xs)], metrics
