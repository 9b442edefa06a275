"""Sharding rules, and the placement of trees on a data x model mesh.

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
:class:`Sharded` leaves, cut over ``data`` (or ``(pod, data)``) and
``model`` exactly as the JAX specs say; :func:`gather_params` brings one
back to one device.  ``launch/steps.py::make_train_step(mesh=)`` and the
optimizers take such trees: each data coordinate is a replica that
trains on its own rows (:func:`batch_rows`), gathering each leaf's
``model`` chunk over ``data`` (ZeRO-3), and the M devices of a replica
are the ``model`` ranks of real tensor parallelism: rank j multiplies
only its own slice of each projection (``models/parallel.py``).  An MoE
layer's expert leaves (``experts/gate``, ``up``, ``down``) are the
exception: expert parallelism cuts them over the data axes, and a
device computes with its own chunk of experts, never gathered (the
rows travel to their experts instead, ``models/moe.py``).
:func:`cache_pspecs` is the JAX package's cache rule (there in
``launch/steps.py``; the port's ``launch/steps.py`` imports it from
here);
:func:`shard_cache` places a decode cache as it lays it out, and
:func:`gather_cache` brings it back.
``use_mesh``, ``constrain`` and ``constrain_batch`` are GSPMD hints
inside a jitted function; eager PyTorch has no counterpart, so they are
not ported, nor is ``params_shardings`` (JAX ``NamedSharding``
objects).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import torch

from repro_torch.tree import leaves, tree_map, unflatten

# expert-stacked leaves: cut over the data axes by expert parallelism and
# computed where they lie (``Sharded.expert``)
_EXPERT_LEAF = r"experts/(gate|up|down)$"


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


def params_pspecs(params, mesh, path: str = ""):
    """Spec tree mirroring ``params`` (tensors, or anything with ``shape``
    and ``ndim``).  A leaf under a list is one layer of a stack: its spec
    is the JAX spec of the stacked leaf without the leading entry.
    ``path``: where ``params`` sits in a whole tree (``layers/3``: an
    entry of the layer list, so a stack), for a part of one."""

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

    return walk(params, path, _in_list(path))


def _in_list(path: str) -> bool:
    """Whether ``path`` passes through a list entry (a numeric part)."""
    return any(part.isdigit() for part in path.split("/"))


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


# the cache leaves whose sequence a KV (or MLA latent) cache cuts
_CACHE_SEQ = ("k", "v", "ckv", "krope")


def cache_pspecs(cache, mesh, batch: int):
    """The JAX package's cache sharding rule, a spec per leaf (the JAX
    spec of the stacked leaf without its stack entry): the batch over
    the data axes when they divide it; a KV (or MLA latent) cache's
    sequence over ``model`` (flash-decode's partial softmaxes), or, for
    a batch the data axes do not divide, over every axis it divides
    (else ``data``); a KV cache whose sequence is not cut has its KV
    heads over ``model`` where they divide; an SSM state's heads and a
    conv tail's channels over ``model``."""
    daxes = data_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in daxes)
    msize = mesh.shape.get("model", 1)

    def spec_for(name, leaf):
        spec = [None] * leaf.ndim
        batch_ok = batch % dsize == 0
        if batch_ok:
            spec[0] = _entry(daxes)
        if name in _CACHE_SEQ:
            seq = leaf.shape[1]
            if batch_ok:
                if seq % msize == 0:
                    spec[1] = "model"
            else:
                # batch=1 long context: the sequence over every axis
                full = (*daxes, "model")
                if seq % math.prod(mesh.shape[a] for a in full) == 0:
                    spec[1] = full
                elif "data" in mesh.axis_names and \
                        seq % mesh.shape["data"] == 0:
                    spec[1] = "data"
            if name in ("k", "v") and spec[1] is None \
                    and leaf.shape[2] % msize == 0:
                spec[2] = "model"
        elif name == "ssm":
            if leaf.shape[1] % msize == 0:
                spec[1] = "model"
        elif name == "conv":
            if leaf.shape[2] % msize == 0:
                spec[2] = "model"
        return tuple(spec)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)([walk(v, str(i)) for i, v in enumerate(node)])
        return spec_for(name, node)

    return walk(cache, "")


# ---------------------------------------------------------------------------
# Placement on a data x model mesh
# ---------------------------------------------------------------------------

class Sharded:
    """One leaf of a tree placed on a mesh's D devices.

    The devices are in the mesh's row-major order, ``model`` innermost,
    so device d sits at data coordinate ``d // ranks`` and model
    coordinate ``d % ranks`` (``ranks`` is the ``model`` size M).  The
    leaf is cut along ``dim`` into ``parts`` contiguous chunks (the
    dimension its spec puts on ``data`` or ``(pod, data)``; ``parts`` is
    the data size, or pod x data, or 1 with ``dim`` None) and along
    ``model_dim`` into ``model_parts`` chunks (M, or 1 with
    ``model_dim`` None).  ``shards[d]`` lives on device d and holds data
    chunk ``(d // ranks) % parts`` and model chunk ``(d % ranks) %
    model_parts``: a leaf uncut along an axis is copied whole to every
    device of that axis.  Where ``dim`` and ``model_dim`` are one
    dimension (a spec entry ``(data, model)`` or ``(pod, data, model)``:
    the batch-1 long-context cache's sequence) it is cut into ``parts x
    model_parts`` slices, slice ``c · model_parts + k`` on the device of
    data chunk c and model chunk k: device d holds slice d, in the
    mesh's device order.  A chunk's first holder (:meth:`owner`) owns
    it: gradient sums and norms read the owners' shards only.  An
    ``expert`` leaf (an MoE layer's expert weights) is computed with
    where it lies: :meth:`local` gives device d its own shard.
    """

    __slots__ = ("dim", "parts", "model_dim", "model_parts", "ranks",
                 "expert", "shards")

    def __init__(self, shards: Sequence[torch.Tensor], dim: Optional[int]
                 = None, parts: int = 1, model_dim: Optional[int] = None,
                 model_parts: int = 1, ranks: int = 1, expert: bool = False):
        self.dim, self.parts = dim, parts
        self.model_dim, self.model_parts = model_dim, model_parts
        self.ranks, self.expert, self.shards = ranks, expert, list(shards)

    def _layout(self) -> tuple:
        return (self.dim, self.parts, self.model_dim, self.model_parts,
                self.ranks, self.expert)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        if self.dim is not None:
            s[self.dim] *= self.parts
        if self.model_dim is not None:
            s[self.model_dim] *= self.model_parts
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def numel(self) -> int:
        return math.prod(self.shape)

    def owner(self, d: int) -> int:
        """The first device that holds device d's chunks."""
        c = (d // self.ranks) % self.parts
        return c * self.ranks + (d % self.ranks) % self.model_parts

    def like(self, shards: Sequence[torch.Tensor]) -> "Sharded":
        """A leaf of this layout holding ``shards``."""
        return Sharded(shards, *self._layout())

    def map(self, fn) -> "Sharded":
        """``fn`` over every shard, in a leaf of the same layout."""
        return self.like([fn(s) for s in self.shards])

    def place(self, full: torch.Tensor) -> "Sharded":
        """``full`` (the whole leaf, on any device) cut and copied as this
        leaf is: each shard a fresh tensor on this shard's device."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"a tensor of shape {tuple(full.shape)} cannot "
                             f"take the place of a {tuple(self.shape)} leaf")
        return _split(full, self._layout(), [s.device for s in self.shards])

    def spans(self, d: int) -> tuple:
        """The span ``(lo, hi)`` of each dimension of the whole leaf that
        device d's shard holds."""
        shape = self.shards[d].shape
        starts = [0] * len(shape)
        c, k = (d // self.ranks) % self.parts, (d % self.ranks) % \
            self.model_parts
        if self.dim is not None and self.dim == self.model_dim:
            starts[self.dim] = (c * self.model_parts + k) * shape[self.dim]
        else:
            if self.dim is not None:
                starts[self.dim] = c * shape[self.dim]
            if self.model_dim is not None:
                starts[self.model_dim] = k * shape[self.model_dim]
        return tuple((lo, lo + n) for lo, n in zip(starts, shape))

    def block(self, k: int, device) -> torch.Tensor:
        """Model chunk ``k``, whole along the data dimension, on
        ``device``: the data chunks' owners' shards concatenated (the
        chunk's own shard itself when the leaf is uncut over data and it
        is already there)."""
        if self.parts == 1:
            return self.shards[k].to(device)
        return torch.cat([self.shards[c * self.ranks + k].to(device)
                          for c in range(self.parts)], self.dim)

    def local(self, d: int) -> torch.Tensor:
        """What device d computes with: its own shard where the leaf is
        uncut over data or an ``expert`` leaf, else its model chunk
        gathered over data onto it."""
        if self.parts == 1 or self.expert:
            return self.shards[d]
        return self.block((d % self.ranks) % self.model_parts,
                          self.shards[d].device)

    def gather(self, device) -> torch.Tensor:
        """The whole leaf on ``device``."""
        if self.dim is not None and self.dim == self.model_dim:
            return torch.cat([self.shards[c * self.ranks + k].to(device)
                              for c in range(self.parts)
                              for k in range(self.model_parts)], self.dim)
        blocks = [self.block(k, device) for k in range(self.model_parts)]
        return blocks[0] if len(blocks) == 1 else torch.cat(
            blocks, self.model_dim)

    def __repr__(self):
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"dim={self.dim}, parts={self.parts}, model_dim="
                f"{self.model_dim}, model_parts={self.model_parts}, "
                f"expert={self.expert}, "
                f"devices={[str(s.device) for s in self.shards]})")


def _split(x: torch.Tensor, layout: tuple, devices) -> Sharded:
    dim, parts, mdim, mparts, ranks, _ = layout
    size = x.shape[dim] // parts if dim is not None else 0
    msize = x.shape[mdim] // mparts if mdim is not None else 0
    shards = []
    for d, dev in enumerate(devices):
        chunk = x
        if dim is not None:
            chunk = chunk.narrow(dim, ((d // ranks) % parts) * size, size)
        if mdim is not None:
            # one dimension on both: the model cut of the data chunk
            n = msize // parts if mdim == dim else msize
            chunk = chunk.narrow(mdim, ((d % ranks) % mparts) * n, n)
        shards.append(chunk.detach().to(
            dev, memory_format=torch.contiguous_format, copy=True))
    return Sharded(shards, *layout)


def _placement(spec: tuple, mesh, expert: bool = False) -> tuple:
    """A spec's layout on ``mesh``: (dim, parts) of the dimension put on
    ``data`` or ``(pod, data)``, (model_dim, model_parts) of the one put
    on ``model``, the ``model`` size and ``expert``."""
    ranks = mesh.shape.get("model", 1)
    dim, parts, mdim, mparts = None, 1, None, 1
    for i, ax in enumerate(spec):
        names = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(mesh.shape[a] for a in names if a in ("pod", "data"))
        if n > 1:
            dim, parts = i, n
        if "model" in names and ranks > 1:
            mdim, mparts = i, ranks
    return dim, parts, mdim, mparts, ranks, expert


def shard_params(tree, mesh, path: str = ""):
    """``tree`` placed on ``mesh``'s devices by :func:`params_pspecs`.

    Each leaf becomes a :class:`Sharded`, cut along the dimension its
    spec puts on ``data`` (or ``(pod, data)``) and the one it puts on
    ``model``, as the JAX specs lay it out; an axis the spec leaves out
    (or whose cut the divisibility check dropped) gets whole copies.
    The shards are fresh tensors (the caller's leaves are not aliased),
    so a mesh may repeat a device.  An MoE layer's expert leaves are
    marked ``expert`` (:meth:`Sharded.local`).  ``path``: where
    ``tree`` sits in a whole parameter tree, for a part of one
    (:func:`placer`).
    """
    specs = _spec_leaves(params_pspecs(tree, mesh, path))
    return unflatten(tree, [
        _split(x, _placement(spec, mesh, bool(re.search(_EXPERT_LEAF,
                                                        at))),
               mesh.devices)
        for x, spec, at in zip(leaves(tree), specs,
                               _leaf_paths(tree, path))])


def placer(mesh):
    """``transformer.init_lm``'s ``place`` for ``mesh``: each part of the
    tree cut by :func:`shard_params` at its path as soon as it is drawn
    (the whole part is then freed), so no device holds more than its
    shards and one part."""
    return lambda path, part: shard_params(part, mesh, path)


def gather_params(sharded, device):
    """A tree of whole leaves on ``device`` from a tree of
    :class:`Sharded` leaves (a plain tensor leaf is moved)."""
    return tree_map(lambda x: x.gather(device) if isinstance(x, Sharded)
                    else x.to(device), sharded)


def _leaf_paths(tree, root: str = "") -> list:
    """The ``/``-joined path of each leaf of ``tree`` (under ``root``), in
    :func:`repro_torch.tree.leaves` order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node is not None:
            out.append(path)

    walk(tree, f"/{root}" if root else "")
    return out


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


def batch_rows(x: torch.Tensor, num_replicas: int, microbatches: int,
               r: int) -> torch.Tensor:
    """Replica r's rows of a batch tensor ``x`` (B, ...) split into
    ``microbatches`` G over ``num_replicas`` R (the mesh's data
    coordinates, pod x data): of each microbatch g's rows ``[g·B/G,
    (g+1)·B/G)`` the r-th contiguous block of B/(G·R), for g in order
    (the rows GSPMD gives data coordinate r when a microbatch's batch dim
    is sharded over the data axes; every ``model`` rank of the replica
    takes them).  Row block g of the result is replica r's part of
    microbatch g."""
    G, R, B = microbatches, num_replicas, x.shape[0]
    if B % (G * R):
        raise ValueError(f"a batch of {B} rows does not split into {G} "
                         f"microbatches over {R} data-parallel replicas")
    rest = tuple(x.shape[1:])
    return x.reshape(G, R, B // (G * R), *rest)[:, r].reshape(B // R, *rest)


def shard_batch(batch: dict, mesh, microbatches: int = 1) -> list:
    """``batch`` (a dict of (B, ...) tensors) as one dict per device of
    ``mesh``: device d holds :func:`batch_rows` of its replica ``d //
    ranks`` on its device."""
    R, M = len(mesh.replicas), mesh.ranks
    return [{k: batch_rows(v, R, microbatches, d // M).to(dev)
             for k, v in batch.items()} for d, dev in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# Placement of decode caches
# ---------------------------------------------------------------------------

def _cache_placements(caches, mesh, batch: int) -> list:
    specs = _spec_leaves(cache_pspecs(caches, mesh, batch))
    return [_placement(spec, mesh) for spec in specs]


def shard_cache(caches, mesh, batch: int):
    """``caches`` (a decode cache tree of whole leaves, any device)
    placed on ``mesh`` as :func:`cache_pspecs` lays it out
    for ``batch`` rows: each leaf a :class:`Sharded` cut along the
    dimension its spec puts on the data axes (the batch; for a batch
    they do not divide, a KV or latent cache's sequence) and the one it
    puts on ``model`` (a KV cache's sequence, else its KV heads; an SSM
    state's heads; a conv tail's channels), copied whole over an axis
    its spec leaves out.  A sequence on ``(data, model)`` or ``(pod,
    data, model)`` is cut into ``mesh.size`` slices in device order.  A
    leaf on the ``meta`` device gives zeroed shards, made on their
    devices."""
    out = []
    for x, layout in zip(leaves(caches),
                         _cache_placements(caches, mesh, batch)):
        if x.device.type != "meta":
            out.append(_split(x, layout, mesh.devices))
            continue
        dim, parts, mdim, mparts = layout[:4]
        shape = list(x.shape)
        if dim is not None:
            shape[dim] //= parts
        if mdim is not None:
            shape[mdim] //= mparts
        out.append(Sharded([torch.zeros(shape, dtype=x.dtype, device=dev)
                            for dev in mesh.devices], *layout))
    return unflatten(caches, out)


def gather_cache(sharded, device):
    """The whole decode cache on ``device`` from :func:`shard_cache`'s
    tree."""
    return gather_params(sharded, device)


def device_views(tree, d: int):
    """Device d's shards of a tree of :class:`Sharded` leaves, as a tree
    of plain tensors (a view of the same storage: an in-place write
    lands in the shard)."""
    return tree_map(lambda x: x.shards[d], tree)


def device_spans(tree, d: int):
    """What device d's shards of a tree of :class:`Sharded` leaves hold:
    a tree of the same shape whose leaves are :meth:`Sharded.spans`."""
    return unflatten(tree, [x.spans(d) for x in leaves(tree)])


def replicated(caches) -> bool:
    """Whether each replica of a serving mesh holds the whole batch, read
    from a cache tree of :class:`Sharded` leaves: more than one replica,
    and no leaf cut along its batch (:func:`cache_pspecs` cuts the batch
    over the data axes wherever they divide it)."""
    xs = leaves(caches)
    return len(xs[0].shards) > xs[0].ranks and all(x.dim != 0 for x in xs)
