"""Carry weights and engine state over from the JAX package.

Every function takes plain numpy data (what ``np.asarray`` makes of the
JAX package's arrays), so nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.cohort.engine import CohortState
from repro_torch.core.embedding import WeightEmbedder


def dqn_params_from_jax(params: Sequence[Mapping]) -> dict:
    """``QNet`` state dict from the JAX Q-network's parameter list.

    ``params`` is the list of ``{"w": (in, out), "b": (out,)}`` layers of
    ``qnet_init``; ``w`` is transposed to ``nn.Linear``'s ``(out, in)``.
    Load the result with ``QNet.load_state_dict``.
    """
    state = {}
    for i, p in enumerate(params):
        w = np.asarray(p["w"], np.float32)
        if w.ndim != 2:
            raise ValueError(f"layer {i}: w must be 2-D, got {w.shape}")
        b = np.asarray(p["b"], np.float32)
        if b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: b {b.shape} does not match w "
                             f"{w.shape}")
        state[f"layers.{i}.weight"] = torch.from_numpy(w.T.copy())
        state[f"layers.{i}.bias"] = torch.from_numpy(b.copy())
    return state


def cohort_state_from_jax(state) -> CohortState:
    """The port's :class:`CohortState` with the JAX engine's warm-start
    payload: landmark indices, bandwidth and the two eigenbases, plus the
    drift sketch the warm-start gate measures against (the sketch is the
    same numpy function of the table and seed in both packages).

    The fingerprint and cached result stay empty, so the next select
    solves (warm, if the table drifted little) instead of replaying a
    JAX result.
    """
    def arr(v, dtype):
        return None if v is None else np.array(v, dtype)

    return CohortState(
        sketch=arr(state.sketch, np.float32),
        num_clients=int(state.num_clients),
        landmark_idx=arr(state.landmark_idx, np.int64),
        gamma=None if state.gamma is None else float(state.gamma),
        w_basis=arr(state.w_basis, np.float32),
        mm_basis=arr(state.mm_basis, np.float32))


def cnn_params_from_jax(params: Mapping) -> dict:
    """The CNN's state dict from the JAX package's ``cnn_init`` tree.

    ``params`` maps each layer (``conv0``…``conv3``, ``fc1``, ``fc2``) to
    ``{"w", "b"}``: conv weights HWIO become OIHW, dense weights (in, out)
    become (out, in).  :func:`repro_torch.core.embedding.jax_layout` is
    the inverse.  Load the result with ``CNN.load_state_dict`` or use it
    as the runner's ``global_params``.
    """
    state = {}
    for layer, leaves in params.items():
        w = np.asarray(leaves["w"], np.float32)
        b = np.asarray(leaves["b"], np.float32)
        if w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)
        elif w.ndim == 2:
            w = w.T
        else:
            raise ValueError(f"{layer}: w must be 2-D or 4-D, got {w.shape}")
        if b.shape != (w.shape[0],):
            raise ValueError(f"{layer}: b {b.shape} does not match "
                             f"{w.shape[0]} outputs")
        state[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w))
        state[f"{layer}.bias"] = torch.from_numpy(b.copy())
    return state


def embedder_from_jax(proj, *, device=None) -> WeightEmbedder:
    """A :class:`WeightEmbedder` applying the JAX embedder's (dim, n)
    projection (``np.asarray(embedder.proj)``)."""
    return WeightEmbedder.from_projection(proj, device=device)


def _leaf(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: via f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _tree(node, index=None):
    """Dicts of leaves as tensors; ``index`` picks one entry along each
    leaf's leading (``repeats``) axis."""
    if isinstance(node, Mapping):
        return {k: _tree(v, index) for k, v in node.items()}
    return _leaf(node if index is None else np.asarray(node)[index])


def lm_params_from_jax(params_np: Mapping, cfg) -> dict:
    """The port's LM parameters from the JAX package's ``init_lm`` tree.

    ``params_np`` is that tree with numpy leaves: ``segments`` stacked on
    a leading ``repeats`` axis, dense ``w`` as (in, out).  The port keeps
    the (in, out) layout and lists the layers in order, so segment s's
    repeat r, period position j becomes ``layers[...]`` in the order the
    JAX scan applies them.  An MoE block's ``moe`` leaves (the f32
    router, the (E, ·, ·) experts and the shared MLP) keep their layout
    too, and so do an MLA block's leaves.  deepseek-v3's
    multi-token-prediction head (``mtp``: ``proj``, ``norm`` and one
    block, not stacked on a ``repeats`` axis) is carried leaf for leaf.
    """
    from repro_torch.models.transformer import build_plan

    out = {k: _tree(params_np[k])
           for k in ("embed", "final_norm", "lm_head", "mtp")
           if k in params_np}
    layers = []
    plan = build_plan(cfg)
    if len(params_np["segments"]) != len(plan):
        raise ValueError(f"{len(params_np['segments'])} segments, expected "
                         f"{len(plan)}")
    for (repeats, types), seg in zip(plan, params_np["segments"]):
        blocks = seg["blocks"]
        if len(blocks) != len(types):
            raise ValueError(f"a segment of period {len(types)} has "
                             f"{len(blocks)} blocks")
        for r in range(repeats):
            for pos in range(len(types)):
                layers.append(_tree(blocks[pos], r))
    out["layers"] = layers
    return out


def encdec_params_from_jax(params_np: Mapping, cfg) -> dict:
    """The port's encoder-decoder parameters from the JAX package's
    ``init_encdec`` tree (numpy leaves).

    The encoder's and the decoder's blocks, stacked there on a leading
    axis of ``num_encoder_layers`` and ``num_layers`` entries, become
    lists in layer order; ``embed``, ``final_norm``, ``lm_head`` and both
    stacks' ``norm`` are carried leaf for leaf.
    """
    out = {k: _tree(params_np[k])
           for k in ("embed", "final_norm", "lm_head") if k in params_np}
    for part, n in (("encoder", cfg.num_encoder_layers),
                    ("decoder", cfg.num_layers)):
        blocks = params_np[part]["blocks"]
        depth = {np.asarray(leaf).shape[0] for leaf in _leaves(blocks)}
        if depth != {n}:
            raise ValueError(f"{part} blocks stacked {sorted(depth)} deep, "
                             f"expected {n}")
        out[part] = {"blocks": [_tree(blocks, i) for i in range(n)],
                     "norm": _tree(params_np[part]["norm"])}
    return out


def _leaves(node):
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
