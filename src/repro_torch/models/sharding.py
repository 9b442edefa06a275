"""Sharding rules, and data-parallel placement of trees on a mesh.

Port of the JAX package's ``models/sharding.py``.  The rule engine maps
each parameter (or optimizer-state) leaf to a spec: a tuple with one
entry per dimension, each ``None``, an axis name, or a tuple of axis
names; the empty tuple means replicated (the JAX ``P()``).  A mesh is
anything with ``axis_names`` and a ``shape`` mapping each name to its
size (``launch/mesh.py::NamedMesh``).

Conventions, as in the JAX package:

* ``model`` axis: tensor parallelism, attention heads, FFN hidden dim,
  vocab dim of the embedding and LM head, the expert-ff dim of MoE
  tensors.
* ``data`` axis: batch data parallelism and FSDP (ZeRO-3) sharding of
  parameters and optimizer state along a non-model dimension when it
  divides.
* ``pod`` axis (multi-pod mesh only): pure data parallelism across pods.

Rules are divisibility-checked: a dimension is only sharded if the axis
size divides it, else that dimension is replicated.

The port's LM tree lists its layers unstacked (``layers/<i>/...``,
``encoder/blocks/<i>/...``) where the JAX tree stacks them on a leading
axis.  A leaf under a list therefore stands for one entry of a stacked
JAX leaf, and its spec is the stacked leaf's spec without the leading
entry (which no rule shards).

Execution: :func:`shard_params` places a tree on a mesh's devices as
:class:`Sharded` leaves (``launch/steps.py::make_train_step`` and the
optimizers take such trees), :func:`gather_params` brings one back to
one device.  Only the ``data`` and ``pod`` axes run: a ``model`` axis
larger than 1 raises.  ``use_mesh``, ``constrain`` and
``constrain_batch`` are GSPMD hints inside a jitted function; eager
PyTorch has no counterpart, so they are not ported, nor is
``params_shardings`` (JAX ``NamedSharding`` objects).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import torch

from repro_torch.tree import leaves, tree_map, unflatten

# the ROADMAP items that would lift the two refusals of this slice
TENSOR_PARALLEL_ITEM = "ROADMAP §A, 'the model axis (tensor parallelism)'"
MOE_MESH_ITEM = "ROADMAP §A, 'the MoE layer under a data mesh'"


def data_axes(mesh):
    """Axes used for batch data parallelism: ('pod','data') or ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

# Each rule: (path regex, dimension tags). Specs are given for the *unstacked*
# parameter; a leading scan/stack dimension (layers) is detected by ndim
# mismatch and padded with None on the left.
#
# Dimension tags:  'm' -> model axis, 'f' -> fsdp(data) axis, '.' -> None.
_RULES = [
    # Embedding / LM head: vocab on model, d_model on fsdp.
    (r"(^|/)embed(/w)?$", "mf"),
    (r"(^|/)lm_head(/w)?$", "fm"),
    (r"(^|/)mtp.*proj(/w)?$", "fm"),
    # Attention projections.
    (r"wq(/w)?$", "fm"),
    (r"wk(/w)?$", "fm"),
    (r"wv(/w)?$", "fm"),
    (r"wo(/w)?$", "mf"),
    (r"w(q|k|v)/b$", "m"),
    # MLA projections.
    (r"wq_a(/w)?$", "f."),
    (r"wq_b(/w)?$", ".m"),
    (r"wkv_a(/w)?$", "f."),
    (r"wkv_b(/w)?$", ".m"),
    (r"wo_mla(/w)?$", "mf"),
    # MoE: expert-stacked tensors (E, d, ff) / (E, ff, d).  They must
    # precede the dense-FFN rules: the generic (gate|up)$ pattern also
    # matches "experts/gate" and would shadow them.  Experts shard over
    # the data axes (expert parallelism) with the expert-ff dim over
    # model; 'F' spans (pod, data).
    (r"experts/(gate|up)$", "F.m"),
    (r"experts/down$", "Fm."),
    # Dense FFN.
    (r"(gate|up)(/w)?$", "fm"),
    (r"down(/w)?$", "mf"),
    (r"router(/w)?$", "f."),
    (r"shared/(gate|up)(/w)?$", "fm"),
    (r"shared/down(/w)?$", "mf"),
    # Mamba2.
    (r"in_proj(/w)?$", "fm"),
    (r"out_proj(/w)?$", "mf"),
    (r"conv_w$", "..m"),
    (r"conv_b$", "m"),
    (r"(A_log|D|dt_bias)$", "m"),
    # Norm scales and other small vectors: replicate.
    (r".*", None),
]


def _axis_size(mesh, ax) -> int:
    if isinstance(ax, tuple):
        return math.prod(mesh.shape[a] for a in ax)
    return mesh.shape[ax]


def _spec_for(path: str, ndim: int, shape, mesh) -> tuple:
    fsdp = "data" if "data" in mesh.axis_names else None
    model = "model" if "model" in mesh.axis_names else None
    big_fsdp = data_axes(mesh)
    for pat, tags in _RULES:
        if re.search(pat, path):
            if tags is None:
                return ()
            spec = []
            for tag in tags:
                if tag == "m":
                    spec.append(model)
                elif tag == "f":
                    spec.append(fsdp)
                elif tag == "F":
                    spec.append(big_fsdp if big_fsdp else None)
                else:
                    spec.append(None)
            # left-pad for stacked (scan) leading dims
            spec = [None] * (ndim - len(spec)) + spec
            spec = spec[:ndim]
            # divisibility check: drop axes that don't divide
            out = []
            for dim, ax in zip(shape, spec):
                if ax is not None and dim % _axis_size(mesh, ax) != 0:
                    # tuple axes degrade to their last component
                    if (isinstance(ax, tuple) and len(ax) > 1
                            and dim % mesh.shape[ax[-1]] == 0):
                        ax = ax[-1]
                    else:
                        ax = None
                # unwrap 1-tuples: ("data",) names the same sharding as
                # "data", and specs compare equal only in one form
                if isinstance(ax, tuple) and len(ax) == 1:
                    ax = ax[0]
                out.append(ax)
            return tuple(out)
    return ()


def params_pspecs(params, mesh):
    """Spec tree mirroring ``params`` (tensors, or anything with ``shape``
    and ``ndim``).  A leaf under a list is one layer of a stack: its spec
    is the JAX spec of the stacked leaf without the leading entry."""

    def walk(node, path, stacked):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k, stacked)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)([walk(v, f"{path}/{i}", True)
                               for i, v in enumerate(node)])
        if not stacked:
            return _spec_for(path, node.ndim, tuple(node.shape), mesh)
        spec = _spec_for(path, node.ndim + 1, (1, *node.shape), mesh)
        return spec[1:]

    return walk(params, "", False)


def _entry(axes: tuple):
    """A spec entry for ``axes``: one axis by its name (a JAX
    ``PartitionSpec`` reads ("data",) as "data"), none as ``None``."""
    return axes[0] if len(axes) == 1 else (axes or None)


def batch_pspec(mesh, ndim: int, batch_dim: int = 0,
                batch_size: Optional[int] = None) -> tuple:
    axes = data_axes(mesh)
    size = math.prod(mesh.shape[a] for a in axes)
    spec = [None] * ndim
    if batch_size is None or batch_size % size == 0:
        spec[batch_dim] = _entry(axes)
    return tuple(spec)


def kv_cache_pspec(mesh, *, batch: int, ndim: int, batch_dim: int,
                   seq_dim: int) -> tuple:
    """KV-cache spec: batch over (pod,data) when divisible; otherwise shard
    the sequence dim over 'data' (flash-decode style) and replicate batch."""
    axes = data_axes(mesh)
    size = math.prod(mesh.shape[a] for a in axes)
    spec = [None] * ndim
    if batch % size == 0:
        spec[batch_dim] = _entry(axes)
    else:
        spec[seq_dim] = "data" if "data" in mesh.axis_names else None
    return tuple(spec)


# ---------------------------------------------------------------------------
# Data-parallel placement
# ---------------------------------------------------------------------------

def data_parallel_devices(mesh) -> tuple:
    """The mesh's devices, in row-major order, for data-parallel work.

    Raises on a ``model`` axis larger than 1: tensor parallelism is not
    ported.
    """
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"a mesh with a 'model' axis of {mesh.shape['model']}: tensor "
            f"parallelism is not ported ({TENSOR_PARALLEL_ITEM}); use "
            f"model=1")
    return tuple(mesh.devices)


class Sharded:
    """One leaf of a tree placed on a mesh's D devices.

    The leaf is cut along ``dim`` into ``parts`` contiguous chunks of
    equal size; ``shards[d]`` lives on the mesh's device d and holds
    chunk ``d % parts``.  ``parts`` is D for a leaf sharded over every
    data-parallel device, the ``data`` size for one sharded over
    ``data`` and replicated over ``pod``, and 1 (``dim`` None) for a
    replicated leaf: then every device holds its own copy.  Chunk k's
    first holder, device k, owns it: gradient sums and norms read the
    owners' shards only.
    """

    __slots__ = ("dim", "parts", "shards")

    def __init__(self, dim: Optional[int], parts: int,
                 shards: Sequence[torch.Tensor]):
        self.dim, self.parts, self.shards = dim, parts, list(shards)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        if self.dim is not None:
            s[self.dim] *= self.parts
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def numel(self) -> int:
        return math.prod(self.shape)

    def map(self, fn) -> "Sharded":
        """``fn`` over every shard, in a leaf of the same layout."""
        return Sharded(self.dim, self.parts, [fn(s) for s in self.shards])

    def place(self, full: torch.Tensor) -> "Sharded":
        """``full`` (the whole leaf, on any device) cut and copied as this
        leaf is: each shard a fresh tensor on this shard's device."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"a tensor of shape {tuple(full.shape)} cannot "
                             f"take the place of a {tuple(self.shape)} leaf")
        return _split(full, self.dim, self.parts,
                      [s.device for s in self.shards])

    def gather(self, device) -> torch.Tensor:
        """The whole leaf on ``device`` (the first shard itself when the
        leaf is replicated and already there)."""
        if self.parts == 1:
            return self.shards[0].to(device)
        return torch.cat([s.to(device) for s in self.shards[:self.parts]],
                         self.dim)

    def __repr__(self):
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"dim={self.dim}, parts={self.parts}, "
                f"devices={[str(s.device) for s in self.shards]})")


def _split(x: torch.Tensor, dim: Optional[int], parts: int,
           devices) -> Sharded:
    size = x.shape[dim] // parts if dim is not None else 0
    shards = []
    for d, dev in enumerate(devices):
        chunk = x if dim is None else x.narrow(dim, (d % parts) * size, size)
        shards.append(chunk.detach().to(
            dev, memory_format=torch.contiguous_format, copy=True))
    return Sharded(dim, parts, shards)


def _placement(spec: tuple, mesh):
    """(dim, parts) of a spec on a data-parallel mesh: the dimension put
    on ``data`` or ``(pod, data)`` and the number of its chunks."""
    for dim, ax in enumerate(spec):
        names = ax if isinstance(ax, tuple) else (ax,)
        names = tuple(a for a in names if a in ("pod", "data"))
        parts = math.prod(mesh.shape[a] for a in names)
        if parts > 1:
            return dim, parts
    return None, 1


def shard_params(tree, mesh):
    """``tree`` placed on ``mesh``'s devices by :func:`params_pspecs`.

    Each leaf becomes a :class:`Sharded`: cut into contiguous chunks
    along the dimension its spec puts on ``data`` (or ``(pod, data)``),
    chunk d on device d, or copied whole to every device when its spec
    shards nothing.  The shards are fresh tensors (the caller's leaves
    are not aliased), so a mesh may repeat a device.
    """
    devices = data_parallel_devices(mesh)
    specs = _spec_leaves(params_pspecs(tree, mesh))
    out = []
    for x, spec in zip(leaves(tree), specs):
        dim, parts = _placement(spec, mesh)
        out.append(_split(x, dim, parts, devices))
    return unflatten(tree, out)


def gather_params(sharded, device):
    """A tree of whole leaves on ``device`` from a tree of
    :class:`Sharded` leaves (a plain tensor leaf is moved)."""
    return tree_map(lambda x: x.gather(device) if isinstance(x, Sharded)
                    else x.to(device), sharded)


def _spec_leaves(specs) -> list:
    """The specs of a spec tree (dicts and lists of specs) in
    :func:`repro_torch.tree.leaves` order; a spec is a tuple, which that
    walk would descend into."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(specs)
    return out



def batch_rows(x: torch.Tensor, num_devices: int, microbatches: int,
               d: int) -> torch.Tensor:
    """Device d's rows of a batch tensor ``x`` (B, ...) split into
    ``microbatches`` G over ``num_devices`` D: of each microbatch g's
    rows ``[g·B/G, (g+1)·B/G)`` the d-th contiguous block of B/(G·D),
    for g in order (the rows GSPMD gives device d when a microbatch's
    batch dim is sharded over the data axes).  Row block g of the result
    is device d's part of microbatch g."""
    G, D, B = microbatches, num_devices, x.shape[0]
    if B % (G * D):
        raise ValueError(f"a batch of {B} rows does not split into {G} "
                         f"microbatches over {D} devices")
    rest = tuple(x.shape[1:])
    return x.reshape(G, D, B // (G * D), *rest)[:, d].reshape(B // D, *rest)


def shard_batch(batch: dict, mesh, microbatches: int = 1) -> list:
    """``batch`` (a dict of (B, ...) tensors) as one dict per device of
    ``mesh``, each holding :func:`batch_rows` on its device."""
    devices = data_parallel_devices(mesh)
    return [{k: batch_rows(v, len(devices), microbatches, d).to(dev)
             for k, v in batch.items()} for d, dev in enumerate(devices)]
