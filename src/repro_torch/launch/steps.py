"""Prefill and decode step builders for every arch, as the JAX package's
``launch/steps.py`` builds them.

``make_prefill_step(cfg, shape)`` and ``make_decode_step(cfg, shape)``
return plain functions over the port's parameter trees: the
encoder-decoder family (seamless-m4t-medium) goes through
``models/encdec.py``, every other arch through
``models/transformer.py``.  This is the encoder-decoder's serving
route; ``launch/serve.py::Server`` serves every config, seamless
included, as a decoder-only LM, as the JAX ``Server`` does.

``shape`` is a :class:`repro_torch.configs.base.ShapeConfig`: its
``global_batch`` is the batch and its ``seq_len`` the self cache's
length, so a prompt shorter than ``seq_len`` leaves room for decode.
Caches are allocated on the device of the parameters.

Not ported: the input, parameter and cache ``ShapeDtypeStruct``s, their
shardings, ``build_step`` and ``lower_step`` (the TPU mesh).  The
training half (``num_microbatches``, ``make_optimizer``,
``make_train_step``) comes with the LM-training slice.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T


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
