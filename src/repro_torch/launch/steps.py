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
(:func:`num_microbatches`).

Not ported: the input, parameter and cache ``ShapeDtypeStruct``s, their
shardings, ``build_step`` and ``lower_step`` (the TPU mesh).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, clip_by_global_norm, linear_warmup_cosine
from repro_torch.tree import leaves, unflatten

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
                    dp: int = 1) -> Callable:
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)``: one optimizer step on ``batch`` (``tokens`` and
    ``labels`` (B, S); ``src_embeds`` for the encoder-decoder,
    ``prefix_embeds`` for a VLM).

    The batch splits into G = :func:`num_microbatches` microbatches of
    B / G rows.  Each one's loss is differentiated with
    ``torch.autograd.grad`` over detached aliases of the parameter leaves
    (the caller's tensors never come to require grad): bf16 leaves get
    bf16 grads, as in the JAX package.  The grads are accumulated as ``(g.float() / G)`` in an f32
    accumulator (bf16 above 5e10 parameters); with G = 1 they are only
    cast to f32.  Then ``clip_by_global_norm(·, 1.0)`` and
    ``opt.update``, which writes the new parameters and moments in place
    (:mod:`repro_torch.optim`).  The metrics are the loss function's,
    averaged over the microbatches and detached, plus ``grad_norm``
    (before clipping).
    """
    G = num_microbatches(cfg, shape, dp)
    loss_fn = (ED.encdec_train_loss if cfg.is_encoder_decoder
               else T.lm_train_loss)
    acc_dtype = torch.bfloat16 if _large(cfg) else torch.float32

    def grad_fn(params, flat, mb):
        loss, metrics = loss_fn(params, cfg, mb)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, step, batch):
        # differentiate detached aliases of the leaves: they share the
        # caller's storage, so the in-place update lands there, and the
        # caller's tensors never come to require grad (served after a
        # step, they still take the kernels)
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten(params, flat)
        if G == 1:
            metrics, grads = grad_fn(live, flat, batch)
            acc = [g.float() for g in grads]
        else:
            acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                   for p in flat]
            ms = []
            for i in range(G):
                mb = {k: v.reshape(G, v.shape[0] // G, *v.shape[1:])[i]
                      for k, v in batch.items()}
                m, grads = grad_fn(live, flat, mb)
                for a, g in zip(acc, grads):
                    a.add_((g.float() / G).to(a.dtype))
                del grads
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads, gnorm = clip_by_global_norm(unflatten(params, acc), 1.0)
        params, opt_state = opt.update(grads, opt_state, params, step)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step
