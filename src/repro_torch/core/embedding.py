"""Weight embedding: reduce model weights to low-dimensional vectors.

Port of the JAX package's ``core/embedding.py``.  A fixed Gaussian random
projection (Johnson–Lindenstrauss) maps the flattened weights to ``dim``
numbers; an exact PCA is kept for parity experiments.

The flattening order and layout are the JAX package's, so the same
projection gives the same embeddings in both packages:
``jax.tree.leaves`` sorts dict keys, so the leaves come as ``conv0.b,
conv0.w, conv1.b, …, fc1.b, fc1.w, fc2.b, fc2.w``, with conv weights in
HWIO and dense weights as (in, out).  :func:`jax_layout` turns a PyTorch
state dict (OIHW convs, (out, in) dense weights) into that tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def jax_layout(params) -> dict:
    """``{layer: {"b": bias, "w": weight}}`` in the JAX package's layout.

    ``params`` maps ``"<layer>.weight"`` / ``"<layer>.bias"`` to tensors:
    a 4-D (O, I, H, W) conv weight becomes HWIO, a 2-D (out, in) dense
    weight becomes (in, out).  Views, no copies.
    """
    tree: dict = {}
    for key, t in params.items():
        layer, leaf = key.rsplit(".", 1)
        if leaf == "weight":
            if t.dim() == 4:
                t = t.permute(2, 3, 1, 0)
            elif t.dim() == 2:
                t = t.transpose(0, 1)
            tree.setdefault(layer, {})["w"] = t
        elif leaf == "bias":
            tree.setdefault(layer, {})["b"] = t
        else:
            raise ValueError(f"unexpected parameter {key!r}")
    return tree


def flatten_params(params):
    """One f32 vector of every parameter, in JAX leaf order and layout."""
    tree = jax_layout(params)
    return torch.cat([tree[layer][leaf].reshape(-1).float()
                      for layer in sorted(tree)
                      for leaf in sorted(tree[layer])])


class WeightEmbedder:
    """Fixed random projection R^{n_params} -> R^{dim}.

    The (dim, n) projection is N(0, 1)/sqrt(n), drawn from a CPU generator
    seeded ``seed`` and kept on ``device`` (``"cuda"`` unless the caller
    passes another).
    """

    def __init__(self, template_params, dim: int = 2, seed: int = 0, *,
                 device=None):
        n = int(sum(t.numel() for t in template_params.values()))
        gen = torch.Generator().manual_seed(int(seed))
        proj = torch.randn((dim, n), generator=gen) / np.sqrt(n)
        self.dim = dim
        self.proj = proj.to(resolve_device(device))

    @classmethod
    def from_projection(cls, proj, *, device=None) -> "WeightEmbedder":
        """An embedder that applies the given (dim, n) projection."""
        self = cls.__new__(cls)
        self.proj = torch.as_tensor(np.asarray(proj, np.float32),
                                    device=resolve_device(device))
        self.dim = self.proj.shape[0]
        return self

    def _embed(self, params):
        return self.proj @ flatten_params(params)

    def __call__(self, params) -> np.ndarray:
        with torch.no_grad():
            return self._embed(params).cpu().numpy()

    def embed_many(self, stacked_params) -> np.ndarray:
        """Params stacked along a leading client axis -> (clients, dim)."""
        with torch.no_grad():
            return torch.func.vmap(self._embed)(stacked_params).cpu().numpy()


def pca_embed(mats: np.ndarray, dim: int = 2) -> np.ndarray:
    """Exact PCA for parity checks.  mats: (n, p) -> (n, dim)."""
    x = mats - mats.mean(axis=0, keepdims=True)
    u, s, _ = np.linalg.svd(x, full_matrices=False)
    return u[:, :dim] * s[:dim]
