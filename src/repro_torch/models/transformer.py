"""Decoder-only LM over attention, MLA and SSM blocks: training loss,
prefill and decode.

Port of the JAX package's ``models/transformer.py`` for the ``attn``,
``mla`` (``models/mla.py``) and ``ssm`` mixers with a dense, MoE
(``models/moe.py``) or no FFN, and for VLM prefix embeddings
(``prefix_embeds``, concatenated before the tokens).  As in the JAX
package, an encoder-decoder config (seamless-m4t-medium) builds here as
a decoder-only stack of its ``num_layers`` (attention, dense) blocks,
which is what the JAX ``Server`` serves; its real route, encoder and
cross-attention, is ``models/encdec.py`` through the step builders of
``launch/steps.py``.  deepseek-v3's multi-token-prediction head
(``params["mtp"]``) is built as the JAX package builds it; serving never
reads it, and :func:`lm_train_loss` adds its loss (:func:`mtp_loss`).

The training loss never materializes (B, S, vocab) logits: the
cross-entropy runs over sequence chunks (:func:`chunked_ce_loss`).  With
``remat`` each block runs under ``torch.utils.checkpoint`` (its
activations are recomputed in the backward pass), where the JAX package
wraps each scan body in ``jax.checkpoint(nothing_saveable)``.  The
loss's attention and SSD take the plain PyTorch path even with
``ops.use_pallas()`` on, as the reference's training never reaches a
Pallas kernel (``models/attention.py::_flash_route``).

Parameters are a dict like the JAX package's, except that the layers are
a list in layer order (``params["layers"][i]`` is layer i's block dict)
where the JAX package stacks each segment on a leading ``repeats`` axis
for ``lax.scan``: a Python loop over the layers takes the scan's place.
Caches are a list too, one dict per layer, each leaf with the request
**slot** on axis 0.  Attention and MLA caches are written in place
(``models/attention.py``, ``models/mla.py``).

:func:`lm_train_loss_tp` is the training loss under tensor parallelism:
the ``model`` ranks of a :class:`repro_torch.models.parallel.Group`
each hold their slices of the parameters (``models/sharding.py``'s
rules), and the forward runs as per-rank lists: a vocab-parallel
embedding and cross-entropy, column- and row-parallel attention, MLA,
Mamba-2 and MLP layers, norms on each rank's copy of the hidden state,
the MTP head (:func:`mtp_loss_tp`).  :func:`lm_train_loss_mesh` runs
the loss over every replica of a data x model mesh at once, layer by
layer, because an MoE layer routes the whole microbatch's tokens
(``models/moe.py::moe_apply_mesh``).  With ``remat`` each layer,
collectives included, is recomputed in the backward pass by
:func:`checkpoint_tp`; on fake tensors (the dry run's) such a layer
replays its op-by-op count, taken once per layer signature
(``roofline/counting.py::counted_call``).  :func:`lm_prefill_mesh` and
:func:`lm_decode_step_mesh` serve over such a mesh the same way, with
each device's shards of the caches threaded through the blocks.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._common import is_fake
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as PL
from repro_torch.models import sharding as SH
from repro_torch.models.parallel import work
from repro_torch.roofline.counting import counted_call
from repro_torch.tree import leaves, tree_map, unflatten


# -- layer plan ---------------------------------------------------------------

def layer_types(cfg):
    """Per-layer (mixer, ffn) type tags."""
    out = []
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            mixer = "mla" if cfg.use_mla else "attn"
        else:
            mixer = "ssm"
        if cfg.d_ff == 0 and not cfg.is_moe_layer(i):
            ffn = "none"
        else:
            ffn = "moe" if cfg.is_moe_layer(i) else "dense"
        out.append((mixer, ffn))
    return out


def build_plan(cfg):
    """Segments: list of (repeats, period_types tuple), as the JAX package
    groups its layers (the order of :func:`lm_params_from_jax`)."""
    types = layer_types(cfg)
    segments = []
    i = 0
    fd = cfg.first_dense_layers
    if fd:
        assert all(t == types[0] for t in types[:fd])
        segments.append((fd, (types[0],)))
        i = fd
    rest = types[i:]
    if not rest:
        return segments
    period = 1
    while period <= len(rest):
        if len(rest) % period == 0:
            pat = rest[:period]
            if all(rest[j] == pat[j % period] for j in range(len(rest))):
                break
        period += 1
    segments.append((len(rest) // period, tuple(rest[:period])))
    return segments


# -- blocks -------------------------------------------------------------------

def _block_init(gen, cfg, mixer, ffn, device):
    p = {"mixer_norm": L.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                      device=device)}
    if mixer == "attn":
        p["attn"] = A.attn_init(gen, cfg, device=device)
    elif mixer == "mla":
        p["mla"] = MLA.mla_init(gen, cfg, device=device)
    else:
        p["ssm"] = M.mamba_init(gen, cfg, device=device)
    if ffn == "dense":
        p["ffn_norm"] = L.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                       device=device)
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.mlp_act,
                              dtype=cfg.param_dtype, device=device)
    elif ffn == "moe":
        p["ffn_norm"] = L.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                       device=device)
        p["moe"] = MOE.moe_init(gen, cfg, device=device)
    return p


def _block_cache(cfg, mixer, batch, max_seq, dtype, device):
    if mixer == "attn":
        return A.init_kv_cache(cfg, batch, max_seq, dtype, device=device)
    if mixer == "mla":
        return MLA.init_mla_cache(cfg, batch, max_seq, dtype, device=device)
    return M.init_mamba_cache(cfg, batch, dtype, device=device)


def _block_apply(p, cfg, h, mixer, ffn, *, positions, window, cache=None,
                 cache_pos=None):
    """One block.  Returns (h, new cache, aux): aux is an MoE layer's
    metrics dict from ``moe_apply`` (None for another FFN), which
    :func:`moe_aux_loss` weighs into the JAX package's aux scalar only
    where a loss wants it, so serving launches nothing for it."""
    aux = None
    hn = L.rmsnorm(p["mixer_norm"], h, cfg.norm_eps)
    if mixer == "attn":
        out, new_cache = A.attention(p["attn"], hn, cfg, positions=positions,
                                     window=window, cache=cache,
                                     cache_pos=cache_pos)
    elif mixer == "mla":
        out, new_cache = MLA.mla_attention(p["mla"], hn, cfg,
                                           positions=positions, window=window,
                                           cache=cache, cache_pos=cache_pos)
    else:
        out, new_cache = M.mamba_apply(p["ssm"], hn, cfg, cache=cache)
    h = h + out.to(h.dtype)
    if ffn == "dense":
        hn = L.rmsnorm(p["ffn_norm"], h, cfg.norm_eps)
        h = h + L.mlp(p["ffn"], hn, act=cfg.mlp_act).to(h.dtype)
    elif ffn == "moe":
        hn = L.rmsnorm(p["ffn_norm"], h, cfg.norm_eps)
        out, aux = MOE.moe_apply(p["moe"], hn, cfg)
        h = h + out.to(h.dtype)
    return h, new_cache, aux


# an MoE layer's metrics, in the order the mesh block returns them
MOE_METRICS = ("moe_aux_loss", "moe_z_loss", "moe_dropped_frac")


def _block_apply_tp(ps, hs, *, cfg, mixer, ffn, group, window):
    """One block over a group's ranks (no cache): ``ps`` and ``hs`` are
    the ranks' parameters and copies of the hidden state.  An MoE FFN
    routes over this group's tokens alone (a one-replica mesh)."""
    return _block_apply_mesh(ps, hs, cfg=cfg, mixer=mixer, ffn=ffn,
                             groups=[group], window=window)[:len(ps)]


def _block_apply_mesh(ps, hs, *, cfg, mixer, ffn, groups, window,
                      caches=None, cache_pos=None):
    """One block over a mesh's devices: ``ps`` and ``hs`` are every
    device's parameters and copy of its replica's hidden state, replica
    after replica (``groups``: the replicas' groups of ranks).  The
    mixer and a dense FFN run replica by replica in their
    tensor-parallel forms; an MoE FFN routes the replicas' tokens
    together (``moe_apply_mesh``), and its metrics (``MOE_METRICS``)
    follow the D hidden states in the returned list.

    ``caches`` (the layer's cache of ``sharding.Sharded`` leaves) and
    ``cache_pos`` (each device's position: 0 for a prompt, its rows'
    positions for a decode step) make it the serving block.  A decode
    step's attention or MLA runs over every replica at once
    (``attention_decode_mesh``, ``mla_decode_mesh``).  Where every
    replica holds the whole batch (``sharding.replicated``: one the data
    axes do not divide) an MoE layer routes replica 0's tokens once and
    copies its output to the other replicas."""
    ranks = groups[0].size
    parts = [slice(r * ranks, (r + 1) * ranks) for r in range(len(groups))]
    replicated = caches is not None and SH.replicated(caches)
    hn = [L.rmsnorm(p["mixer_norm"], h, cfg.norm_eps)
          for p, h in zip(ps, hs)]
    mp = [p[mixer] for p in ps]
    if caches is not None and mixer != "ssm" and hs[0].shape[1] == 1:
        decode = A.attention_decode_mesh if mixer == "attn" \
            else MLA.mla_decode_mesh
        o = decode(groups, mp, hn, cfg, caches, cache_pos, window=window)
    else:
        views, spans = ([None] * len(ps),) * 2 if caches is None \
            else cache_views(caches, len(ps))
        o = []
        for group, sl in zip(groups, parts):
            cached = {} if caches is None else dict(caches=views[sl],
                                                    spans=spans[sl])
            if mixer == "attn":
                o += A.attention_tp(group, mp[sl], hn[sl], cfg,
                                    window=window, **cached)
            elif mixer == "mla":
                o += MLA.mla_attention_tp(group, mp[sl], hn[sl], cfg,
                                          window=window, **cached)
            else:
                o += M.mamba_apply_tp(group, mp[sl], hn[sl], cfg,
                                      caches=cached.get("caches"))
    out = [h + x.to(h.dtype) for h, x in zip(hs, o)]
    if ffn == "dense":
        hn = [L.rmsnorm(p["ffn_norm"], h, cfg.norm_eps)
              for p, h in zip(ps, out)]
        o = []
        for group, sl in zip(groups, parts):
            o += L.mlp_tp(group, [p["ffn"] for p in ps[sl]], hn[sl],
                          cfg.d_ff, cfg.mlp_act)
        out = [h + x.to(h.dtype) for h, x in zip(out, o)]
    if ffn != "moe":
        return out
    hn = [L.rmsnorm(p["ffn_norm"], h, cfg.norm_eps) for p, h in zip(ps, out)]
    if replicated:
        hn = [h if d < ranks else h[:0] for d, h in enumerate(hn)]
    o, metrics = MOE.moe_apply_mesh(groups, [p["moe"] for p in ps], hn, cfg)
    if replicated:
        o = [o[d % ranks].to(h.device) for d, h in enumerate(out)]
    return [h + x.to(h.dtype) for h, x in zip(out, o)] + \
        [metrics[k] for k in MOE_METRICS]


def maybe_checkpoint(fn, remat: bool):
    """``fn`` itself, or ``fn`` under ``torch.utils.checkpoint`` (its
    activations recomputed in the backward pass) with ``remat``."""
    if not remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _discard(_):
    return None


class _Remat(torch.autograd.Function):
    """``run(tensors)`` without its activations: the forward keeps only
    the inputs, and the backward runs it again under autograd and
    differentiates that.  The forward runs as a differentiated call too,
    its saved tensors discarded, so both runs take the training loss's
    routes (``kernels._common.differentiated``: no kernel)."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        ctx.save_for_backward(*tensors)
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(_discard, _discard):
            outs = run([t.detach().requires_grad_(t.requires_grad)
                        for t in tensors])
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        tensors = [t.detach().requires_grad_(t.requires_grad)
                   for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.run(tensors)
        wanted = [t for t in tensors if t.requires_grad]
        # an output no input reaches (an MoE layer's dropped share) has
        # no gradient to pass on
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True,
                                       materialize_grads=True))
        return (None, *[next(got) if t.requires_grad else None
                        for t in tensors])


def checkpoint_tp(fn, remat: bool, ps, *acts):
    """``fn(ps, *acts)``, a tensor-parallel block (``ps`` the ranks'
    parameters, each of ``acts`` a per-rank list of tensors; it returns
    a list of tensors), with ``remat`` recomputed in the backward pass,
    collectives included; the ranks may be a whole mesh's devices.
    ``torch.utils.checkpoint`` cannot take it: with the ranks on several
    cards the backward pass runs on a thread a card, and two threads
    would recompute one block at once; here one autograd node recomputes
    the whole block and differentiates it.  On fake tensors the block,
    recomputation included, replays its op-by-op count, taken once for
    every block of the same signature (``counting.counted_call``)."""
    flat = [t for p in ps for t in leaves(p)] + [t for a in acts for t in a]
    if not (remat or is_fake(flat[0])):
        return fn(ps, *acts)
    # the trees' shapes, not their tensors: a count kept for later blocks
    # holds no tensor of this one
    shapes = [tree_map(lambda _: 0, p) for p in ps]
    counts = [len(leaves(p)) for p in ps]
    sizes = [len(a) for a in acts]

    def run(tensors):
        it = iter(tensors)
        ranks = [unflatten(p, [next(it) for _ in range(n)])
                 for p, n in zip(shapes, counts)]
        return fn(ranks, *[[next(it) for _ in range(n)] for n in sizes])

    def block(*tensors):
        return _Remat.apply(run, *tensors) if remat else tuple(run(tensors))

    if is_fake(flat[0]):
        static = _static(fn)
        out = counted_call("block", block, flat, key=None if static is None
                           else (static, remat, tuple(counts), tuple(sizes)))
        return list(out) if isinstance(out, tuple) else [out]
    return list(block(*flat))


def _static(fn):
    """A hashable stand-in for a block function: its function and its
    bound arguments, a group of ranks as its devices; None for a closure
    (made anew at each call, so no later block shares its count)."""
    def value(v):
        if isinstance(v, PL.Group):
            return tuple(map(str, v.devices))
        if isinstance(v, (list, tuple)):
            return tuple(map(value, v))
        return v
    func = getattr(fn, "func", fn)
    if getattr(func, "__closure__", None) is not None:
        return None
    kw = getattr(fn, "keywords", {})
    return (func, tuple(map(value, getattr(fn, "args", ()))),
            tuple(sorted((k, value(v)) for k, v in kw.items())))


def moe_aux_loss(cfg, aux, device=None):
    """The JAX package's aux scalar from :func:`lm_hidden`'s per-layer MoE
    metrics: the sum over MoE layers of ``router_aux_weight ·
    moe_aux_loss + router_z_weight · moe_z_loss``, float32 (0 without
    MoE layers)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for m in aux:
        total = total + cfg.router_aux_weight * m["moe_aux_loss"] \
            + cfg.router_z_weight * m["moe_z_loss"]
    return total


# -- model init / forward -----------------------------------------------------

def init_lm(gen, cfg, *, device=None, place=None):
    """Random LM parameters drawn from ``gen`` (a generator on ``device``).

    bf16 configs are drawn in f32 one tensor at a time and cast (an MoE
    layer's experts one (E, ·, ·) tensor at a time), so the peak is the
    parameters plus the largest tensor in f32: at moonshot-v1-16b-a3b the
    (163840, 2048) embedding, 1.34 GB.

    ``place(path, part)``, if given, takes each part of the tree as soon
    as it is drawn (``embed``, ``final_norm``, ``lm_head``, each
    ``layers/<i>``, ``mtp``) and returns what the tree holds in its
    place; ``sharding.placer(mesh)`` cuts it onto a mesh, so a model
    that fits no device is made with one part whole at a time.  The
    draws do not depend on it.
    """
    place = place or (lambda path, part: part)
    params = {}
    params["embed"] = place("embed", L.embed_init(
        gen, cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype,
        device=device))
    params["final_norm"] = place("final_norm", L.rmsnorm_init(
        cfg.d_model, dtype=cfg.param_dtype, device=device))
    if not cfg.tie_embeddings:
        params["lm_head"] = place("lm_head", L.dense_init(
            gen, cfg.d_model, cfg.vocab_size, dtype=cfg.param_dtype,
            device=device))
    params["layers"] = [
        place(f"layers/{i}", _block_init(gen, cfg, mixer, ffn, device))
        for i, (mixer, ffn) in enumerate(layer_types(cfg))]
    if cfg.mtp_depth > 0:
        # deepseek-v3's depth-1 multi-token-prediction head, as the JAX
        # package builds it; serving never reads it
        params["mtp"] = place("mtp", {
            "proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                 dtype=cfg.param_dtype, device=device),
            "norm": L.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                   device=device),
            "block": _block_init(gen, cfg, "mla" if cfg.use_mla else "attn",
                                 "dense" if cfg.d_ff else "none", device),
        })
    return params


def params_to(params, device):
    """The parameter (or cache) tree with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params.to(device)


def init_lm_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """Decode caches for ``batch`` independent request **slots**: one dict
    per layer, every leaf (batch, ...), so axis 0 is the slot table."""
    return [_block_cache(cfg, mixer, batch, max_seq, dtype, device)
            for mixer, _ in layer_types(cfg)]


def cache_slot(caches, slot: int):
    """Views of slot ``slot``: a standalone width-1 cache."""
    return [{k: t[slot: slot + 1] for k, t in layer.items()}
            for layer in caches]


def write_cache_slot(caches, slot_caches, slot: int):
    """Copy a width-w cache into slots ``[slot, slot + w)``, in place."""
    for layer, part in zip(caches, slot_caches):
        for k, t in layer.items():
            t[slot: slot + part[k].shape[0]] = part[k].to(t.dtype)
    return caches


def lm_hidden(params, cfg, h, *, positions, window=None, caches=None,
              cache_pos=None, remat=False):
    """Run every block.  h: (B,S,d) embedded input.  Returns (normed
    hidden, new caches or None, aux): aux lists the MoE layers' metrics
    dicts in layer order (:func:`moe_aux_loss` sums them).  ``remat``
    recomputes each block's activations in the backward pass."""
    new_caches = [] if caches is not None else None
    aux = []
    block = maybe_checkpoint(_block_apply, remat)
    for i, (mixer, ffn) in enumerate(layer_types(cfg)):
        c = caches[i] if caches is not None else None
        h, nc, a = block(params["layers"][i], cfg, h, mixer, ffn,
                         positions=positions, window=window, cache=c,
                         cache_pos=cache_pos)
        if a is not None:
            aux.append(a)
        if caches is not None:
            new_caches.append(nc)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, new_caches, aux


def embed_inputs(params, cfg, tokens=None, prefix_embeds=None):
    """Token (and optional VLM prefix) embedding -> (B, S, d) in the
    compute dtype; the prefix comes first."""
    cdt = L.dtype_of(cfg.compute_dtype)
    parts = []
    if prefix_embeds is not None:
        parts.append(prefix_embeds.to(cdt))
    if tokens is not None:
        parts.append(L.embed(params["embed"], tokens).to(cdt))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def lm_logits(params, cfg, h):
    """Full logits (f32) — only for small S (decode / last position)."""
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], h)
    else:
        logits = L.dense(params["lm_head"], h)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits.float()


# -- training loss ------------------------------------------------------------

def chunked_ce_loss(params, cfg, h, labels, mask=None, chunk: int = 512):
    """Mean cross-entropy over (B, S) without materializing (B, S, V)
    logits: the sequence runs in chunks of ``chunk`` positions (the last
    padded, its padding masked out), each chunk's f32 logits live only
    for that chunk's term.  ``mask`` (B, S) weighs each position."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    labels = labels.long()
    mask = (torch.ones((B, S), dtype=torch.float32, device=h.device)
            if mask is None else mask.float())
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S + pad, chunk):
        logits = lm_logits(params, cfg, h[:, i:i + chunk])   # (B,chunk,V)
        lc, mc = labels[:, i:i + chunk], mask[:, i:i + chunk]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        tot = tot + torch.sum((lse - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


def chunked_ce_loss_tp(group, ps, cfg, hs, labels, mask=None,
                       chunk: int = 512):
    """:func:`chunked_ce_loss` over a group's ranks with vocab-parallel
    logits: rank j's block of ``lm_head`` (or of the tied embedding)
    gives its block of each chunk's logits, so no rank holds the whole
    vocab's (a vocab the ``model`` axis does not divide is rank 0's
    alone).  The logsumexp takes the ranks' max, then sums their
    ``exp`` sums in rank order; the rank whose block holds a label
    supplies its logit.  ``hs``, ``labels``: per-rank copies; ``mask``
    (B, S) on rank 0's device or None.  Returns the loss on rank 0's
    device."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    dim = 0 if cfg.tie_embeddings else 1
    spans = [work(j, group.size, p[key]["w"].shape[dim], cfg.vocab_size)
             for j, p in enumerate(ps)]
    B, S, d = hs[0].shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    dev0 = group.devices[0]
    labels = [lab.long() for lab in labels]
    mask = (torch.ones((B, S), dtype=torch.float32, device=dev0)
            if mask is None else mask.float())
    if pad:
        hs = [torch.nn.functional.pad(h, (0, 0, 0, pad)) for h in hs]
        labels = [torch.nn.functional.pad(lab, (0, pad)) for lab in labels]
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=dev0)
    cnt = torch.zeros((), dtype=torch.float32, device=dev0)
    for i in range(0, S + pad, chunk):
        logits = [None if sp is None else
                  lm_logits(p, cfg, h[:, i:i + chunk])
                  for p, h, sp in zip(ps, hs, spans)]
        top = group.all_max([None if lg is None else lg.amax(-1)
                             for lg in logits])
        sums, golds = [], []
        for lg, m, lab, sp in zip(logits, top, labels, spans):
            if lg is None:
                sums.append(None)
                golds.append(None)
                continue
            sums.append(torch.exp(lg - m[..., None]).sum(-1))
            lc = lab[:, i:i + chunk]
            inside = (lc >= sp[0]) & (lc < sp[1])
            gold = torch.gather(lg, -1, torch.where(
                inside, lc - sp[0], 0)[..., None])[..., 0]
            golds.append(torch.where(inside, gold, 0.0))
        lse = top[0] + torch.log(group.reduce(sums))
        mc = mask[:, i:i + chunk]
        tot = tot + torch.sum((lse - group.reduce(golds)) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


def _apply_single_block(p, cfg, h, positions):
    mixer = "mla" if cfg.use_mla else "attn"
    ffn = "dense" if cfg.d_ff else "none"
    return _block_apply(p, cfg, h, mixer, ffn, positions=positions,
                        window=cfg.attn_window)


def mtp_loss(params, cfg, h, tokens, labels_next2, mask=None):
    """DeepSeek-V3 depth-1 multi-token-prediction auxiliary loss.

    Combines the main-path hidden state at position t with the embedding
    of ``tokens`` at t through the MTP head's projection and block, and
    predicts ``labels_next2``.
    """
    if "mtp" not in params:
        return torch.zeros((), dtype=torch.float32, device=h.device)
    mp = params["mtp"]
    emb_next = L.embed(params["embed"], tokens).to(h.dtype)
    hh = torch.cat([L.rmsnorm(mp["norm"], h, cfg.norm_eps), emb_next],
                   dim=-1)
    hh = L.dense(mp["proj"], hh)
    positions = torch.arange(h.shape[1], device=h.device)
    hh2, _, _ = _apply_single_block(mp["block"], cfg, hh, positions)
    return chunked_ce_loss(params, cfg, hh2, labels_next2, mask)


def lm_train_loss(params, cfg, batch, *, remat=True):
    """batch: {tokens (B,S), labels (B,S), [mask], [prefix_embeds]}.
    Returns (loss, metrics): ``ce``, ``aux`` (the MoE auxiliary losses),
    ``mtp`` for an MTP config, and ``loss`` = ce + aux (+ 0.3 · mtp).

    As in the JAX package: a VLM prefix gets no LM loss, and the MTP
    loss reads ``labels`` as its tokens and ``labels`` rolled left by one
    as its targets, so the last position's target wraps round to the
    first label, unmasked.
    """
    tokens = batch["tokens"]
    h = embed_inputs(params, cfg, tokens, batch.get("prefix_embeds"))
    positions = torch.arange(h.shape[1], device=h.device)
    h, _, aux = lm_hidden(params, cfg, h, positions=positions,
                          window=cfg.attn_window, remat=remat)
    aux = moe_aux_loss(cfg, aux, h.device)
    labels = batch["labels"]
    npfx = h.shape[1] - tokens.shape[1]
    if npfx > 0:                       # VLM prefix: no LM loss on patches
        h = h[:, npfx:]
    ce = chunked_ce_loss(params, cfg, h, labels, batch.get("mask"))
    loss = ce + aux
    metrics = {"loss": loss, "ce": ce, "aux": aux}
    if cfg.mtp_depth > 0:
        shifted = torch.roll(labels, -1, dims=1)
        m = mtp_loss(params, cfg, h, labels, shifted)
        loss = loss + 0.3 * m
        metrics["mtp"] = m
        metrics["loss"] = loss
    return loss, metrics


def embed_inputs_tp(group, ps, cfg, batches):
    """:func:`embed_inputs` over a group's ranks (a vocab-parallel
    lookup): per-rank copies of the (B, S, d) input, from per-rank
    copies of the batch."""
    cdt = L.dtype_of(cfg.compute_dtype)
    hs = [h.to(cdt) for h in L.embed_tp(
        group, [p["embed"] for p in ps], [b["tokens"] for b in batches],
        cfg.vocab_size)]
    if "prefix_embeds" in batches[0]:
        hs = [torch.cat([b["prefix_embeds"].to(cdt), h], dim=1)
              for b, h in zip(batches, hs)]
    return hs


def mtp_loss_tp(group, ps, cfg, hs, tokens, labels_next2, mask=None):
    """:func:`mtp_loss` over a group's ranks: each rank's norm of its
    copy of ``hs``, the vocab-parallel embedding of ``tokens``
    (per-rank copies), the concatenation, ``mtp/proj`` column-parallel
    over d_model with its output gathered over the group, the single
    block in its tensor-parallel form, and the vocab-parallel
    cross-entropy against ``labels_next2`` (per-rank copies).  The loss
    on rank 0's device."""
    if "mtp" not in ps[0]:
        return torch.zeros((), dtype=torch.float32,
                           device=group.devices[0])
    mps = [p["mtp"] for p in ps]
    emb = L.embed_tp(group, [p["embed"] for p in ps], tokens, cfg.vocab_size)
    xs = [torch.cat([L.rmsnorm(mp["norm"], h, cfg.norm_eps),
                     e.to(h.dtype)], dim=-1)
          for mp, h, e in zip(mps, hs, emb)]
    d = cfg.d_model
    hh = L.dense_col(group, [mp["proj"] for mp in mps], xs, d,
                     [(0, d)] * group.size)
    hh = _block_apply_tp([mp["block"] for mp in mps], hh, cfg=cfg,
                         mixer="mla" if cfg.use_mla else "attn",
                         ffn="dense" if cfg.d_ff else "none", group=group,
                         window=cfg.attn_window)
    return chunked_ce_loss_tp(group, ps, cfg, hh, labels_next2, mask)


def lm_train_loss_mesh(groups, ps, cfg, batches, *, remat=True):
    """The training loss's terms over a data x model mesh: ``groups``
    the replicas' groups of ranks, ``ps`` and ``batches`` every
    device's parameters and batch rows, replica after replica.  Embed,
    blocks and head run layer by layer across every replica, each
    replica's tensor-parallel forms over its ranks; an MoE layer routes
    all replicas' tokens together (:func:`_block_apply_mesh`), so the
    MoE metrics are the whole microbatch's.  Returns (each replica's
    ``ce`` on its rank 0, each replica's ``mtp`` likewise or None
    without an MTP head, the microbatch's ``aux`` on the first
    device)."""
    ranks = groups[0].size
    parts = [slice(r * ranks, (r + 1) * ranks) for r in range(len(groups))]
    hs = [h for group, sl in zip(groups, parts)
          for h in embed_inputs_tp(group, ps[sl], cfg, batches[sl])]
    aux = []
    for i, (mixer, ffn) in enumerate(layer_types(cfg)):
        block = functools.partial(_block_apply_mesh, cfg=cfg, mixer=mixer,
                                  ffn=ffn, groups=groups,
                                  window=cfg.attn_window)
        out = checkpoint_tp(block, remat, [p["layers"][i] for p in ps], hs)
        hs = out[:len(ps)]
        if ffn == "moe":
            aux.append(dict(zip(MOE_METRICS, out[len(ps):])))
    hs = [L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
          for p, h in zip(ps, hs)]
    npfx = hs[0].shape[1] - batches[0]["tokens"].shape[1]
    if npfx > 0:                       # VLM prefix: no LM loss on patches
        hs = [h[:, npfx:] for h in hs]
    ces, mtps = [], []
    for group, sl in zip(groups, parts):
        labels = [b["labels"] for b in batches[sl]]
        ces.append(chunked_ce_loss_tp(group, ps[sl], cfg, hs[sl], labels,
                                      batches[sl][0].get("mask")))
        if cfg.mtp_depth > 0:
            mtps.append(mtp_loss_tp(group, ps[sl], cfg, hs[sl], labels,
                                    [torch.roll(lab, -1, dims=1)
                                     for lab in labels]))
    return ces, mtps or None, moe_aux_loss(cfg, aux, groups[0].devices[0])


def lm_train_loss_tp(group, ps, cfg, batches, *, remat=True):
    """:func:`lm_train_loss` over a group's ranks: ``ps`` their
    parameter slices, ``batches`` their copies of the batch.  Returns
    (loss, metrics) on rank 0's device, the values of
    :func:`lm_train_loss` (an MoE layer routes this group's tokens)."""
    ces, mtps, aux = lm_train_loss_mesh([group], ps, cfg, batches,
                                        remat=remat)
    ce = ces[0]
    loss = ce + aux
    metrics = {"loss": loss, "ce": ce, "aux": aux}
    if mtps is not None:
        loss = loss + 0.3 * mtps[0]
        metrics["mtp"] = mtps[0]
        metrics["loss"] = loss
    return loss, metrics


def lm_prefill(params, cfg, batch, caches, *, window=None, last_pos=None):
    """Prefill: fill the caches with the prompt, return last-position
    logits (B, V) and the caches.

    ``last_pos`` — optional (B,) of each sequence's final *prompt*
    position; logits are read there instead of at the padded end.  With
    ``batch["prefix_embeds"]`` (B, P, d) the prompt is the prefix and then
    the tokens: positions and ``last_pos`` count the prefix.
    """
    h = embed_inputs(params, cfg, batch.get("tokens"),
                     batch.get("prefix_embeds"))
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches, _ = lm_hidden(params, cfg, h, positions=positions,
                             window=window, caches=caches, cache_pos=0)
    if last_pos is None:
        sel = h[:, -1:]
    else:
        rows = torch.arange(h.shape[0], device=h.device)
        sel = h[rows, torch.as_tensor(last_pos, device=h.device)][:, None]
    return lm_logits(params, cfg, sel)[:, 0], caches


def lm_prefill_slot(params, cfg, batch, caches, slot: int, *, window=None,
                    last_pos=None):
    """Prefill ONE slot of a slotted cache; the others are untouched.

    The prompt runs against a **zeroed** width-1 cache (a slot's previous
    tenant must not seed the new recurrence), written back into ``slot``.
    Returns ``(logits (1, V), caches)``.
    """
    sub = [{k: torch.zeros_like(t) for k, t in layer.items()}
           for layer in cache_slot(caches, slot)]
    logits, sub = lm_prefill(params, cfg, batch, sub, window=window,
                             last_pos=last_pos)
    return logits, write_cache_slot(caches, sub, slot)


def lm_decode_step(params, cfg, token, caches, pos, *, window=None):
    """One decode step.  token: (B,1); pos: an int (every row reads and
    writes one cache position) or a (B,) tensor (row i writes at
    ``pos[i]`` and attends only ``[0, pos[i]]``).  Returns (logits (B,V),
    new caches)."""
    h = embed_inputs(params, cfg, token)
    if torch.is_tensor(pos) and pos.dim() == 1:
        pos = pos.to(h.device)
        positions = pos[:, None]                           # (B, 1) per row
    else:
        pos = int(pos)
        positions = pos + torch.arange(1, device=h.device)
    h, caches, _ = lm_hidden(params, cfg, h, positions=positions,
                             window=window, caches=caches, cache_pos=pos)
    return lm_logits(params, cfg, h)[:, 0], caches


# -- prefill and decode over a data x model mesh ------------------------------

def logits_mesh(groups, ps, cfg, hs, caches):
    """Vocab-parallel logits of each replica's (B_r, 1, d) hidden
    states: rank j's block of ``lm_head`` (or of the tied embedding)
    gives its block of the vocab (a vocab ``model`` does not divide is
    rank 0's alone), and the blocks and the replicas' rows are gathered
    to (B, V) float32 on the mesh's first device; replica 0's rows alone
    where every replica holds the whole batch (the serving cache tree
    ``caches`` says so, ``sharding.replicated``)."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    dim = 0 if cfg.tie_embeddings else 1
    ranks = groups[0].size
    device = groups[0].devices[0]
    rows = []
    for r in range(1 if SH.replicated(caches) else len(groups)):
        blocks = []
        for j in range(ranks):
            p, h = ps[r * ranks + j], hs[r * ranks + j]
            if work(j, ranks, p[key]["w"].shape[dim], cfg.vocab_size):
                blocks.append(lm_logits(p, cfg, h).to(device))
        rows.append(torch.cat(blocks, dim=-1))
    return torch.cat(rows)[:, 0]


def cache_views(caches, D):
    """Each device's shards of a cache tree of ``Sharded`` leaves and
    what they hold: (views, spans), one entry a device
    (``sharding.device_views``, ``sharding.device_spans``)."""
    return ([SH.device_views(caches, d) for d in range(D)],
            [SH.device_spans(caches, d) for d in range(D)])


def _hidden_mesh(groups, ps, cfg, hs, caches, cache_pos, window=None):
    """Every block over the mesh with its cache, then the final norm."""
    for i, (mixer, ffn) in enumerate(layer_types(cfg)):
        out = _block_apply_mesh(
            [p["layers"][i] for p in ps], hs, cfg=cfg, mixer=mixer, ffn=ffn,
            groups=groups, window=window, caches=caches[i],
            cache_pos=cache_pos)
        hs = out[:len(ps)]
    return [L.rmsnorm(p["final_norm"], h, cfg.norm_eps)
            for p, h in zip(ps, hs)]


def lm_prefill_mesh(groups, ps, cfg, batches, caches):
    """:func:`lm_prefill` over a data x model mesh, from position 0.

    ``groups``: the replicas' groups of ranks; ``ps`` and ``batches``:
    every device's parameters (its shards, gathered over ``data`` where
    a leaf is cut there: ``sharding.Sharded.local``) and its replica's
    rows of the batch (``tokens``, ``prefix_embeds`` optional), replica
    after replica; ``caches``: the cache tree (one dict per layer) of
    ``sharding.Sharded`` leaves laid out by
    ``models/sharding.py::cache_pspecs``, written in place.  Layer by
    layer across every replica, as :func:`lm_train_loss_mesh`: the
    embedding and logits vocab-parallel, attention, MLA and Mamba-2
    tensor-parallel with their caches (B9 and B10 per rank), an MoE
    layer routing the whole batch's tokens.  Where the cache's layout
    says every replica holds the whole batch (one the data axes do not
    divide, ``sharding.replicated``), each replica's rows are the whole
    batch and each runs the prompt.  Returns the last position's logits
    (B, V) float32 on the first device."""
    ranks = groups[0].size
    parts = [slice(r * ranks, (r + 1) * ranks) for r in range(len(groups))]
    hs = [h for group, sl in zip(groups, parts)
          for h in embed_inputs_tp(group, ps[sl], cfg, batches[sl])]
    hs = _hidden_mesh(groups, ps, cfg, hs, caches, [0] * len(ps))
    return logits_mesh(groups, ps, cfg, [h[:, -1:] for h in hs], caches)


def lm_decode_step_mesh(groups, ps, cfg, tokens, caches, pos, *,
                        window=None):
    """:func:`lm_decode_step` over a data x model mesh: ``tokens`` and
    ``pos`` are each device's copy of its replica's rows of the (B, 1)
    token and of the positions (a (B_r,) tensor, or one int for every
    row); the rest as :func:`lm_prefill_mesh`.  The attention is
    flash-decode over the cache's slices
    (``attention.attention_decode_mesh``, ``mla.mla_decode_mesh``).
    Returns the logits (B, V) float32 on the first device."""
    ranks = groups[0].size
    parts = [slice(r * ranks, (r + 1) * ranks) for r in range(len(groups))]
    hs = [h for group, sl in zip(groups, parts)
          for h in embed_inputs_tp(group, ps[sl], cfg,
                                   [{"tokens": t} for t in tokens[sl]])]
    hs = _hidden_mesh(groups, ps, cfg, hs, caches, list(pos), window)
    return logits_mesh(groups, ps, cfg, hs, caches)
