"""Train, prefill and decode step builders for every arch, as the JAX
package's ``launch/steps.py`` builds them.

``make_train_step(cfg, shape, opt)``, ``make_prefill_step(cfg, shape)``
and ``make_decode_step(cfg, shape)`` return plain functions over the
port's parameter trees: the encoder-decoder family
(seamless-m4t-medium) goes through ``models/encdec.py``, every other
arch through ``models/transformer.py``.  The prefill and decode
builders are the encoder-decoder's serving route;
``launch/serve.py::Server`` serves every config, seamless included, as a
decoder-only LM, as the JAX ``Server`` does.

``shape`` is a :class:`repro_torch.configs.base.ShapeConfig`: for
serving its ``global_batch`` is the batch and its ``seq_len`` the self
cache's length, so a prompt shorter than ``seq_len`` leaves room for
decode; caches are allocated on the device of the parameters.  For
training it sets the batch and the gradient-accumulation factor
(:func:`num_microbatches`).  ``make_train_step(..., mesh=)`` trains
over a data x model mesh (``launch/mesh.py::make_test_mesh``):
data-parallel over its replicas and tensor-parallel over each replica's
``model`` ranks, on a tree placed by
``models/sharding.py::shard_params``.

The input specs and the bundles, as the JAX package builds them for its
dry-run and launchers: :func:`batch_specs`, :func:`params_specs` and
:func:`cache_specs` return trees of ``device="meta"`` tensors (the
port's ``ShapeDtypeStruct``: shapes and dtypes, no storage), in the
port's layout (layers listed, not stacked); :func:`batch_shardings`
and ``cache_pspecs`` (kept in ``models/sharding.py`` with the parameter
rules, and importable from here as in the JAX package) are the JAX
package's batch and cache sharding rules as spec trees (tuples, as
``models/sharding.py`` writes them), each cache spec the JAX spec
without its stack entry.
:func:`build_step` assembles a :class:`StepBundle` for a train, prefill
or decode shape on a ``launch/mesh.py::NamedMesh``, whose ``fn`` runs
eagerly on trees placed on that mesh: training through
``make_train_step(mesh=)``, serving through the tensor-parallel prefill
and decode of ``models/transformer.py`` (``lm_prefill_mesh``,
``lm_decode_step_mesh``) and ``models/encdec.py`` over caches placed by
``models/sharding.py::shard_cache``.

:func:`lower_step` is the dry run's counterpart of the JAX AOT
lowering: it places a bundle's arguments on a mesh of fake devices
(``launch/mesh.py``, ``device="meta"``) as fake tensors, with the
placement a real run uses (:attr:`StepBundle.place`), and returns a
:class:`LoweredStep` whose :meth:`~LoweredStep.run` runs ``fn`` once
under ``roofline/counting.py``'s counter: per-device memory, FLOPs,
bytes and cross-device copies, with nothing allocated
(``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import parallel as PL
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.models.sharding import cache_pspecs
from repro_torch.optim import adamw, clip_by_global_norm, linear_warmup_cosine
from repro_torch.optim.optimizers import row_slices
from repro_torch.tree import leaves, tree_map, unflatten


# -- microbatch policy (activation memory) ------------------------------------

# the JAX package's gradient-accumulation factors for its train_4k shape
_MICROBATCHES = {
    ("deepseek-v3-671b", "train_4k"): 32,
    ("jamba-v0.1-52b", "train_4k"): 16,
    ("llama4-scout-17b-a16e", "train_4k"): 16,
    ("internvl2-26b", "train_4k"): 8,
    ("qwen3-14b", "train_4k"): 8,
    ("qwen2-7b", "train_4k"): 4,
    ("moonshot-v1-16b-a3b", "train_4k"): 16,
    ("mamba2-2.7b", "train_4k"): 8,
    ("gemma-2b", "train_4k"): 2,
    ("seamless-m4t-medium", "train_4k"): 2,
}


def num_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                     dp: int = 1) -> int:
    """Gradient-accumulation factor, clamped so each microbatch still
    splits evenly over ``dp`` data-parallel ways (1 on one card)."""
    if shape.kind != "train":
        return 1
    g = _MICROBATCHES.get((cfg.name, shape.name), shape.num_microbatches)
    g = max(1, min(g, shape.global_batch // max(dp, 1) or 1))
    while shape.global_batch % (g * max(dp, 1)):
        g -= 1
    return max(g, 1)


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Sliding window for long-context decode on pure-attention archs."""
    if shape.name == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm"):
        return cfg.long_context_window
    return None


# -- input specs (``device="meta"`` tensors) ----------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype_of(dtype), device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for one global batch of this workload (token ids
    int32, as the JAX package's)."""
    B, S = shape.global_batch, shape.seq_len
    cdt = cfg.compute_dtype
    if cfg.is_encoder_decoder:
        return {"src_embeds": _meta((B, S, cfg.d_model), cdt),
                "tokens": _meta((B, S), torch.int32),
                "labels": _meta((B, S), torch.int32)}
    n_text = S - cfg.num_prefix_embeds
    out = {"tokens": _meta((B, n_text), torch.int32),
           "labels": _meta((B, n_text), torch.int32)}
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = _meta(
            (B, cfg.num_prefix_embeds, cfg.d_model), cdt)
    return out


def params_specs(cfg: ModelConfig):
    """The parameter tree on the meta device."""
    init = ED.init_encdec if cfg.is_encoder_decoder else T.init_lm
    return init(None, cfg, device="meta")


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """The decode cache tree on the meta device."""
    if cfg.is_encoder_decoder:
        return ED.init_encdec_cache(cfg, batch, max_seq, device="meta")
    return T.init_lm_cache(cfg, batch, max_seq, device="meta")


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Each batch entry's spec: its rows over the data axes when they
    divide the batch."""
    return {k: SH.batch_pspec(mesh, v.dim(), 0, shape.global_batch)
            for k, v in batch_specs(cfg, shape).items()}


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    """``prefill_step(params, batch) -> (logits (B, V), caches)``: fresh
    caches of ``shape``, filled from position 0.  ``batch`` holds
    ``tokens`` (and ``src_embeds`` for the encoder-decoder,
    ``prefix_embeds`` for a VLM prompt)."""

    def prefill_step(params, batch):
        dev = params["embed"]["w"].device
        if cfg.is_encoder_decoder:
            caches = ED.init_encdec_cache(cfg, shape.global_batch,
                                          shape.seq_len, device=dev)
            return ED.encdec_prefill(params, cfg, batch, caches)
        caches = T.init_lm_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=dev)
        return T.lm_prefill(params, cfg, batch, caches)

    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    """``serve_step(params, caches, token, pos) -> (logits (B, V),
    caches)``: one token (B, 1) against the caches at ``pos`` (an int;
    a (B,) tensor for a decoder-only arch's per-row decode)."""
    window = decode_window(cfg, shape)

    def serve_step(params, caches, token, pos):
        if cfg.is_encoder_decoder:
            return ED.encdec_decode_step(params, cfg, token, caches, pos,
                                         window=window)
        return T.lm_decode_step(params, cfg, token, caches, pos,
                                window=window)

    return serve_step


# -- training -----------------------------------------------------------------

def _large(cfg: ModelConfig) -> bool:
    """Above 5e10 parameters the JAX package keeps bf16 moments and a
    bf16 gradient accumulator."""
    return cfg.param_count() > 5e10


def make_optimizer(cfg: ModelConfig, total_steps: int = 10_000,
                   state_dtype: Optional[str] = None):
    """AdamW with linear warm-up (200 steps) and cosine decay from 3e-4."""
    if state_dtype is None:
        state_dtype = "bfloat16" if _large(cfg) else "float32"
    return adamw(linear_warmup_cosine(3e-4, 200, total_steps),
                 state_dtype=state_dtype)


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, opt,
                    dp: int = 1, *, mesh=None) -> Callable:
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)``: one optimizer step on ``batch`` (``tokens`` and
    ``labels`` (B, S); ``src_embeds`` for the encoder-decoder,
    ``prefix_embeds`` for a VLM; ``mask`` (B, S) optional).

    The batch splits into G = :func:`num_microbatches` microbatches of
    B / G rows.  Each one's loss is differentiated with
    ``torch.autograd.grad`` over detached aliases of the parameter leaves
    (the caller's tensors never come to require grad): bf16 leaves get
    bf16 grads, as in the JAX package.  The grads are accumulated as
    ``(g.float() / G)`` in an f32 accumulator (bf16 above 5e10
    parameters); with G = 1 they are only cast to f32.  Then
    ``clip_by_global_norm(·, 1.0)`` and ``opt.update``, which writes the
    new parameters and moments in place (:mod:`repro_torch.optim`).  The
    metrics are the loss function's, averaged over the microbatches and
    detached, plus ``grad_norm`` (before clipping).

    With ``mesh`` (a ``launch/mesh.py::NamedMesh``) the step trains on
    trees of ``models/sharding.py::Sharded`` leaves (``shard_params``;
    the optimizer state ``opt.init`` of such a tree) over the mesh's R
    replicas (its data coordinates, pod x data) of M ``model`` ranks
    each, with G = ``num_microbatches(cfg, shape, R)``.  ``batch`` is
    one dict per device (``data/pipeline.py``'s iterator with this mesh)
    or a whole batch, cut by ``sharding.shard_batch``: microbatch g keeps
    rows ``[g·B/G, (g+1)·B/G)``, replica r takes the r-th contiguous
    block of them (``sharding.batch_rows``), and its M ranks take the
    same rows.  Once a step each device gets detached aliases of its
    leaves: its own shard where a leaf is uncut over ``data`` or holds
    experts, else its ``model`` chunk gathered over ``data`` onto it
    (``Sharded.local``).  With M = 1 each replica runs the loss above on
    its device; with M >
    1 its ranks run it tensor-parallel (``lm_train_loss_tp``,
    ``encdec_train_loss_tp``): rank j multiplies only its own slice of
    each projection that the rules cut over ``model``.  A replica's loss
    is weighted by its share of the microbatch's CE tokens, so the
    gradients and the metrics are the global batch's.  Each device's
    gradients are reduce-scattered into the owners' accumulator shards
    (a leaf copied to every rank sums its M ranks' gradients), summed in
    device order, and freed before the next replica's microbatch; a
    chunk held by more than one device gets its owner's sum.  The clip
    and the update then run over the shards, each on its own device.
    Without a mesh the step is this one on one device, the caller's
    leaves their own shards, so a one-device mesh gives it bit for bit.

    A config with MoE layers on more than one device trains over the
    whole mesh at once: the JAX MoE routes over the whole microbatch's
    tokens (one data shard), so each microbatch's loss runs layer by
    layer across every replica (``lm_train_loss_mesh``; each MoE layer
    routes globally and sends the rows to the replica that owns their
    experts, ``moe.moe_apply_mesh``), and one ``torch.autograd.grad``
    takes every device's gradients.  ``ce`` is weighted by each
    replica's share of the CE tokens, ``mtp`` by its share of the rows
    (its cross-entropy takes no mask), and ``aux``, already the
    microbatch's, is added once.  An expert leaf is never gathered over
    data: each device computes with its own chunk of experts and its
    gradient goes into that chunk's accumulator shard.
    """
    D = 1 if mesh is None else mesh.size
    M = 1 if mesh is None else mesh.ranks
    R = D // M
    moe_mesh = D > 1 and _has_moe(cfg)
    if shape.global_batch % R:
        raise ValueError(f"a global batch of {shape.global_batch} rows "
                         f"does not split over {R} data-parallel replicas")
    G = num_microbatches(cfg, shape, dp if mesh is None else R)
    if cfg.is_encoder_decoder:
        loss_fn, loss_tp = ED.encdec_train_loss, ED.encdec_train_loss_tp
    else:
        loss_fn, loss_tp = T.lm_train_loss, T.lm_train_loss_tp
    groups = None if mesh is None else [PL.Group(g) for g in mesh.replicas]
    acc_dtype = torch.bfloat16 if _large(cfg) else torch.float32

    def pieces(x, g, d):
        # (owner, its chunk) of device d's gradient g of leaf x: an expert
        # leaf's is its own chunk; another's is its model chunk, whole
        # along the data dimension
        if x.expert:
            return [(x.owner(d), g)]
        k = (d % x.ranks) % x.model_parts
        if x.parts == 1:
            return [(k, g)]
        size = x.shards[k].shape[x.dim]
        return [(c * x.ranks + k, g.narrow(x.dim, c * size, size))
                for c in range(x.parts)]

    def accumulate(acc, sharded, grads, d, devs):
        # device d's gradients into the owners' shards, leaf by leaf
        for i, (x, g) in enumerate(zip(sharded, grads)):
            for o, chunk in pieces(x, g, d):
                with PL.collective("reduce_scatter"):
                    chunk = chunk.to(devs[o])
                if acc[i][o] is None and G == 1:
                    acc[i][o] = chunk.float()
                    continue
                if acc[i][o] is None:
                    acc[i][o] = torch.zeros(chunk.shape, dtype=acc_dtype,
                                            device=devs[o])
                # slice by slice: a large leaf's f32 temporaries stay small
                for a, c in row_slices(acc[i][o], chunk):
                    a.add_(c.float() if G == 1
                           else (c.float() / G).to(acc_dtype))

    def mesh_loss(lives, mbs, devs):
        # the microbatch's loss over every replica at once
        ces, mtps, aux = T.lm_train_loss_mesh(groups, lives, cfg, mbs)
        heads = mbs[::M]
        ce = _weighted_sum(ces, _token_weights(heads, devs[::M]), devs[0])
        loss = ce + aux
        metrics = {"loss": loss, "ce": ce, "aux": aux}
        if mtps is not None:
            rows = _token_weights([{"labels": mb["labels"]} for mb in heads],
                                  devs[::M])
            mtp = _weighted_sum(mtps, rows, devs[0])
            loss = loss + 0.3 * mtp
            metrics.update(mtp=mtp, loss=loss)
        return loss, metrics

    def train_step(params, opt_state, step, batch):
        if mesh is None:
            # the caller's leaves as their own one-device shards: the
            # in-place update lands in them
            def wrap(t):
                return SH.Sharded([t])
            tree, state = tree_map(wrap, params), tree_map(wrap, opt_state)
            devs, shards = (leaves(params)[0].device,), [batch]
        else:
            tree, state, devs = params, opt_state, mesh.devices
            shards = (SH.shard_batch(batch, mesh, G)
                      if isinstance(batch, dict) else list(batch))
            if len(shards) != D:
                raise ValueError(f"{len(shards)} batch shards for a mesh "
                                 f"of {D} devices")
        sharded = leaves(tree)
        # differentiate detached aliases of the leaves: a leaf uncut over
        # data shares the caller's storage, and the caller's tensors
        # never come to require grad (served after a step, they still
        # take the kernels)
        with torch.no_grad():
            flats = [[x.local(d).detach().requires_grad_(True)
                      for x in sharded] for d in range(D)]
        lives = [unflatten(tree, flat) for flat in flats]
        acc = [[None] * D for _ in sharded]
        ms = []
        for g in range(G):
            mbs = [{k: v.reshape(G, v.shape[0] // G, *v.shape[1:])[g]
                    for k, v in shard.items()} for shard in shards]
            if moe_mesh:
                loss, metrics = mesh_loss(lives, mbs, devs)
                grads = torch.autograd.grad(
                    loss, [t for flat in flats for t in flat],
                    materialize_grads=True)
                n = len(sharded)
                for d in range(D):
                    accumulate(acc, sharded, grads[d * n:(d + 1) * n], d,
                               devs)
                del grads, loss
                ms.append({k: v.detach() for k, v in metrics.items()})
                continue
            weights = (_token_weights(mbs[::M], devs[::M]) if R > 1
                       else None)
            parts = []
            for r in range(R):
                ranks = range(r * M, (r + 1) * M)
                if M == 1:
                    loss, metrics = loss_fn(lives[r], cfg, mbs[r])
                else:
                    loss, metrics = loss_tp(groups[r],
                                            [lives[d] for d in ranks], cfg,
                                            [mbs[d] for d in ranks])
                if weights is not None:
                    w = weights[r]
                    loss = loss * (w.to(loss.device) if torch.is_tensor(w)
                                   else w)
                grads = torch.autograd.grad(
                    loss, [t for d in ranks for t in flats[d]],
                    materialize_grads=True)
                for n, d in enumerate(ranks):
                    accumulate(acc, sharded,
                               grads[n * len(sharded):(n + 1) * len(sharded)],
                               d, devs)
                del grads, loss
                parts.append({k: v.detach() for k, v in metrics.items()})
            ms.append(parts[0] if weights is None else
                      {k: _weighted_sum([p[k] for p in parts], weights,
                                        devs[0]) for k in parts[0]})
        del flats, lives
        metrics = ms[0] if G == 1 else {
            k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        # a chunk held by several devices: the owner's sum on each
        with PL.collective("broadcast"):
            grads = [x.like([a[d] if x.owner(d) == d else
                             a[x.owner(d)].to(devs[d], copy=True)
                             for d in range(D)])
                     for x, a in zip(sharded, acc)]
        grads, gnorm = clip_by_global_norm(unflatten(tree, grads), 1.0)
        opt.update(grads, state, tree, step)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def _has_moe(cfg: ModelConfig) -> bool:
    return any(cfg.is_moe_layer(i) for i in range(cfg.num_layers))


def _token_weights(mbs: list, devices: tuple) -> list:
    """Each device's share of a microbatch's loss: its CE token count
    over the microbatch's (``tot / max(cnt, 1)`` is a token mean over
    the whole microbatch).  Python floats without a ``mask``, else f32
    tensors on the first device, summed there in device order."""
    if "mask" not in mbs[0]:
        counts = [float(mb["labels"].numel()) for mb in mbs]
        total = max(sum(counts), 1.0)
        return [c / total for c in counts]
    counts = [mb["mask"].float().sum().to(devices[0]) for mb in mbs]
    total = counts[0]
    for c in counts[1:]:
        total = total + c
    return [c / torch.clamp(total, min=1.0) for c in counts]


def _weighted_sum(values: list, weights: list, device) -> torch.Tensor:
    """Σ_d weights[d] · values[d] on ``device``, added in device order."""
    total = values[0].to(device) * weights[0]
    for v, w in zip(values[1:], weights[1:]):
        total = total + v.to(device) * w
    return total


# -- bundles ------------------------------------------------------------------

@dataclasses.dataclass
class StepBundle:
    """A step and its stand-ins: ``fn``, its ``args`` as meta-tensor
    trees, and ``in_shardings``/``out_shardings`` as spec trees (None: a
    result left where it lands; both None without a mesh).  ``place``
    (with a mesh) turns trees shaped like ``args`` into the arguments
    ``fn`` takes on the mesh, placed as a run places them: parameters by
    ``sharding.shard_params`` and the optimizer state ``opt.init`` of
    them, caches by ``shard_cache``, a batch by ``shard_batch`` (or
    copied whole to every device where the data axes do not divide it);
    a scalar step becomes 0 and a scalar decode position the cache's
    last row."""

    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Any
    out_shardings: Any
    place: Optional[Callable] = None


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
               total_steps: int = 10_000) -> StepBundle:
    """The step for ``shape`` on ``mesh`` (a ``launch/mesh.py::
    NamedMesh``; None: one device and no layout), as the JAX package's
    ``build_step`` assembles it.

    * train: ``make_train_step(mesh=)`` over trees placed by
      ``sharding.shard_params`` (the optimizer state ``opt.init`` of
      such a tree); args (params, opt_state, step, batch).
    * prefill: ``fn(params, batch) -> (logits (B, V), caches)``: fresh
      caches of ``shape.seq_len`` rows, placed by
      ``sharding.shard_cache`` (zeroed on their devices), filled from
      position 0; ``batch`` a whole batch (``tokens``, and
      ``prefix_embeds`` for a VLM prompt), cut into the replicas' rows.
    * decode: ``fn(params, caches, token (B, 1), pos) -> (logits,
      caches)``: ``pos`` a (B,) tensor, or an int for the encoder-decoder
      and the windowed long-context decode, as in the JAX bundle; the
      caches are written in place.

    Serving over a mesh of D > 1 devices runs every replica's ranks
    layer by layer (``transformer.lm_prefill_mesh``,
    ``lm_decode_step_mesh``; the encoder-decoder's
    ``encdec.encdec_prefill_mesh``, ``encdec_decode_step_mesh``): each
    device computes with its parameter shards, gathered over ``data``
    for the step where a leaf is cut there (``Sharded.local``; an
    expert leaf never is), and the logits come back (B, V) on the mesh's
    first device.  A batch that the data axes do not divide is run
    whole by every replica, as the JAX GSPMD program replicates it: its
    cache's sequence is cut over ``(data, model)`` (or ``data``), and a
    decode step's partial softmaxes are combined over the whole mesh.
    A one-device mesh runs the one-device steps on its shards.
    """
    p_specs = params_specs(cfg)
    p_shard = None if mesh is None else SH.params_pspecs(p_specs, mesh)

    if shape.kind == "train":
        opt = make_optimizer(cfg, total_steps)
        opt_specs = opt.init(p_specs)
        b_specs = batch_specs(cfg, shape)
        fn = make_train_step(cfg, shape, opt, mesh=mesh)
        args = (p_specs, opt_specs, _meta((), torch.int32), b_specs)
        if mesh is None:
            return StepBundle(fn, args, None, None)
        opt_shard = SH.params_pspecs(opt_specs, mesh)
        in_sh = (p_shard, opt_shard, (),
                 batch_shardings(cfg, shape, mesh))
        G = num_microbatches(cfg, shape, len(mesh.replicas))

        def place_train(args):
            params = SH.shard_params(args[0], mesh)
            return (params, opt.init(params), 0,
                    SH.shard_batch(args[3], mesh, G))

        return StepBundle(fn, args, in_sh, (p_shard, opt_shard, None),
                          place_train)

    B, S = shape.global_batch, shape.seq_len
    c_specs = cache_specs(cfg, B, S)
    c_shard = None if mesh is None else cache_pspecs(c_specs, mesh, B)
    if shape.kind == "prefill":
        b_specs = batch_specs(cfg, shape)
        b_specs.pop("labels", None)
        fn = (make_prefill_step(cfg, shape) if mesh is None
              else _prefill_on_mesh(cfg, shape, mesh))
        if mesh is None:
            return StepBundle(fn, (p_specs, b_specs), None, None)
        b_shard = batch_shardings(cfg, shape, mesh)
        b_shard.pop("labels", None)

        def place_prefill(args):
            return (SH.shard_params(args[0], mesh),
                    _place_rows(args[1], mesh, B))

        return StepBundle(fn, (p_specs, b_specs), (p_shard, b_shard),
                          (None, c_shard), place_prefill)

    # decode: per-row positions, but a scalar for the encoder-decoder and
    # the windowed long-context decode (its cache slice wants one start)
    scalar = cfg.is_encoder_decoder or decode_window(cfg, shape) is not None
    pos_spec = _meta(() if scalar else (B,), torch.int32)
    args = (p_specs, c_specs, _meta((B, 1), torch.int32), pos_spec)
    fn = (make_decode_step(cfg, shape) if mesh is None
          else _decode_on_mesh(cfg, shape, mesh))
    if mesh is None:
        return StepBundle(fn, args, None, None)
    pos_shard = () if scalar else SH.batch_pspec(mesh, 1, 0, B)
    in_sh = (p_shard, c_shard, SH.batch_pspec(mesh, 2, 0, B), pos_shard)

    def place_decode(args):
        params, caches, token, pos = args
        rows = _place_rows(dict(tokens=token, **({} if scalar else
                                                 {"pos": pos})), mesh, B)
        return (SH.shard_params(params, mesh),
                SH.shard_cache(caches, mesh, B),
                [r["tokens"] for r in rows],
                S - 1 if scalar else [r["pos"] for r in rows])

    return StepBundle(fn, args, in_sh, (None, c_shard), place_decode)


def _place_rows(batch: dict, mesh, B: int) -> list:
    """A whole serving batch as one dict per device: its replica's rows
    (``sharding.shard_batch``) where the data axes divide ``B``, else
    the whole batch copied to every device (as ``cache_pspecs`` then
    lays the cache out, ``sharding.replicated``)."""
    if SH.batch_pspec(mesh, 1, 0, B)[0] is not None:
        return SH.shard_batch(batch, mesh)
    return [{k: v.to(dev, copy=True) for k, v in batch.items()}
            for dev in mesh.devices]


def _local_params(params, D):
    """Each device's parameters for one step (``Sharded.local``)."""
    flat = leaves(params)
    return [unflatten(params, [x.local(d) for x in flat]) for d in range(D)]


def _serving_rows(batch, mesh, caches):
    """Each device's rows of a serving batch (a dict of (B, ...)
    tensors): its replica's (``sharding.shard_batch``), or the whole
    batch on every device where the cache tree's layout says every
    replica holds it (``sharding.replicated``).  A list is one dict per
    device already (:attr:`StepBundle.place`'s)."""
    if isinstance(batch, list):
        return batch
    if SH.replicated(caches):
        return [{k: v.to(dev) for k, v in batch.items()}
                for dev in mesh.devices]
    return SH.shard_batch(batch, mesh)


def _prefill_on_mesh(cfg, shape, mesh) -> Callable:
    one = make_prefill_step(cfg, shape)
    groups = [PL.Group(g) for g in mesh.replicas]
    prefill = ED.encdec_prefill_mesh if cfg.is_encoder_decoder \
        else T.lm_prefill_mesh

    def prefill_step(params, batch):
        if mesh.size == 1:
            logits, caches = one(SH.device_views(params, 0),
                                 batch[0] if isinstance(batch, list)
                                 else batch)
            return logits, tree_map(lambda t: SH.Sharded([t]), caches)
        frames = cfg
        if cfg.is_encoder_decoder:
            # cross caches of the source's length, as the one-device
            # prefill (and the JAX one) builds them
            src = batch[0] if isinstance(batch, list) else batch
            frames = dataclasses.replace(
                cfg, encoder_seq_len=src["src_embeds"].shape[1])
        caches = SH.shard_cache(
            cache_specs(frames, shape.global_batch, shape.seq_len), mesh,
            shape.global_batch)
        with torch.no_grad():
            logits = prefill(
                groups, _local_params(params, mesh.size), cfg,
                _serving_rows(batch, mesh, caches), caches)
        return logits, caches

    return prefill_step


def _decode_on_mesh(cfg, shape, mesh) -> Callable:
    one = make_decode_step(cfg, shape)
    window = decode_window(cfg, shape)
    groups = [PL.Group(g) for g in mesh.replicas]
    decode = ED.encdec_decode_step_mesh if cfg.is_encoder_decoder \
        else T.lm_decode_step_mesh

    def serve_step(params, caches, token, pos):
        if isinstance(token, list):
            # one (B_r, 1) token tensor a device (StepBundle.place)
            toks = token
            poss = pos if isinstance(pos, list) else [int(pos)] * mesh.size
        else:
            per_row = torch.is_tensor(pos) and pos.dim() == 1
            rows = _serving_rows(dict(tokens=token, **(
                {"pos": pos} if per_row else {})), mesh, caches)
            toks = [r["tokens"] for r in rows]
            poss = ([r["pos"] for r in rows] if per_row
                    else [int(pos)] * mesh.size)
        if mesh.size == 1:
            logits, new = one(SH.device_views(params, 0),
                              SH.device_views(caches, 0), toks[0], poss[0])
            # a Mamba layer returns new state tensors: put them in place
            for x, t in zip(leaves(caches), leaves(new)):
                if t is not x.shards[0]:
                    x.shards[0].copy_(t)
            return logits, caches
        with torch.no_grad():
            logits = decode(
                groups, _local_params(params, mesh.size), cfg, toks, caches,
                poss, window=window)
        return logits, caches

    return serve_step


# -- the dry run --------------------------------------------------------------

@dataclasses.dataclass
class LoweredStep:
    """A bundle's arguments placed as fake tensors on a mesh of fake
    devices (:func:`lower_step`), ready to run once."""

    bundle: StepBundle
    mesh: Any
    fake_mode: Any
    args: Tuple[Any, ...]
    place_seconds: float

    def run(self):
        """``bundle.fn`` once on the placed arguments, under
        ``roofline/counting.py::StepCounter`` inside the fake mode:
        nothing is allocated and no kernel or plain version of one runs
        where a wrapper has a shape-only route (with ``use_pallas`` on,
        B9 and B10), and the blocked attention, the SSD scan and each
        layer of a mesh's loss replay their op-by-op count
        (``counting.counted_call``).  Returns the counter's
        :class:`~repro_torch.roofline.counting.StepCount`; ``seconds`` is
        the host time of the fake run; its ``peak_by_op`` holds what each
        device held at its peak, by the op that made it."""
        from repro_torch.roofline.counting import StepCounter

        counter = StepCounter(self.mesh.devices)
        t0 = time.perf_counter()
        with self.fake_mode, counter:
            counter.track_arguments(self.args)
            out = self.bundle.fn(*self.args)
            counter.track_outputs(out)
            del out
        return counter.result(time.perf_counter() - t0)


def lower_step(bundle: StepBundle, mesh) -> LoweredStep:
    """The dry run's counterpart of the JAX package's AOT lowering:
    ``bundle``'s meta-tensor args made fake and placed by
    :attr:`StepBundle.place` on ``mesh``, a ``launch/mesh.py::NamedMesh``
    of fake devices (``device="meta"``, ``meta:0`` ...).  Nothing is
    allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if any(d.type != "meta" for d in mesh.devices) or bundle.place is None:
        raise ValueError(f"lower_step runs a bundle built for a mesh, on "
                         f"fake devices (launch.mesh device='meta'), got "
                         f"{[str(d) for d in mesh.devices]}")
    mode = FakeTensorMode()
    t0 = time.perf_counter()
    fake = tree_map(lambda t: mode.from_tensor(t) if torch.is_tensor(t)
                    else t, bundle.args)
    with mode:
        args = bundle.place(fake)
    del fake
    return LoweredStep(bundle, mesh, mode, args, time.perf_counter() - t0)
