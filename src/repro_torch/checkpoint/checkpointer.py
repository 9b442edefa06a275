"""Parameter-tree checkpointing to .npz (no extra dependency).

Port of the JAX package's ``checkpoint/checkpointer.py``, with the same
file format: a tree (dicts, lists, tuples, ``None``) is flattened to
path-keyed arrays, the path's parts joined by ``::`` (dict keys in
sorted order, list and tuple items as ``#i``, a ``None`` leaf as an
empty array under ``path::__none__``), and written with ``np.savez``.
``Checkpointer`` adds step management (``ckpt_{step:08d}.npz`` plus an
optional ``.json`` of metadata), retention, and atomic writes (tmp +
``os.replace``) so an interrupted save never corrupts the latest
checkpoint.  The port reads the JAX package's checkpoints, and the JAX
package reads the port's as long as they hold no bf16 leaf.

bfloat16 leaves: numpy has no bfloat16 (the JAX package's comes from
``ml_dtypes``, which a reader may lack), so a bf16 tensor is stored as
its raw bits, a uint16 array, under ``path::__bfloat16__``, and read
back bit for bit with plain numpy.  This tag is the port's own: the JAX
package's ``load_pytree`` takes it for a dict key (without a template)
or hands back the uint16 bits as the leaf (with one), so it cannot read
a bf16 checkpoint the port wrote.  Loaded leaves are CPU tensors; with
a ``template``, each takes the place (and device) of the template's
leaf.

Sharded trees (``models/sharding.py::Sharded`` leaves): a sharded leaf
is gathered to the host and written as the whole leaf, so a tree saved
sharded over any data x model mesh writes the file its unsharded tree
writes, byte for byte (``np.savez`` stamps every member with the zip
epoch, so equal trees give equal files).  A sharded leaf of
a ``template`` is cut again as the template's is: a checkpoint saved
on one mesh restores on any other.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.models.sharding import Sharded

_SEP = "::"
_NONE = "__none__"
_BF16 = "__bfloat16__"


def _flatten_with_paths(tree):
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [f"#{i}"])
        elif node is None:
            flat[_SEP.join(path + [_NONE])] = np.zeros((0,))
        elif isinstance(node, Sharded):
            walk(node.gather("cpu"), path)
        elif torch.is_tensor(node) and node.dtype == torch.bfloat16:
            bits = node.detach().cpu().view(torch.int16).numpy()
            flat[_SEP.join(path + [_BF16])] = bits.view(np.uint16)
        elif torch.is_tensor(node):
            flat[_SEP.join(path)] = node.detach().cpu().numpy()
        else:
            flat[_SEP.join(path)] = np.asarray(node)

    walk(tree, [])
    return flat


def _leaf(arr, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten_from_paths(flat: dict, template=None):
    root: Any = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        tag = parts[-1] if parts[-1] in (_NONE, _BF16) else None
        if tag:
            parts = parts[:-1]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if tag == _NONE else _leaf(val, tag == _BF16)

    def fix(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(re.fullmatch(r"#\d+", k) for k in keys):
                return [fix(node[f"#{i}"]) for i in range(len(keys))]
            return {k: fix(v) for k, v in node.items()}
        return node

    tree = fix(root)
    if template is not None:
        # the template's tuples, lists and leaf devices
        want, got = _tree.leaves(template), _tree.leaves(tree)
        if len(want) != len(got):
            raise ValueError("checkpoint does not match template structure")
        got = [w.place(g) if isinstance(w, Sharded)
               else g.to(w.device) if torch.is_tensor(w) else g
               for w, g in zip(want, got)]
        return _tree.unflatten(template, got)
    return tree


def save_pytree(path: str, tree) -> None:
    flat = _flatten_with_paths(tree)
    dirn = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirn, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirn, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, template=None):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_from_paths(flat, template)


class Checkpointer:
    """Step-indexed checkpoint directory with retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> str:
        path = self._path(step)
        save_pytree(path, tree)
        if metadata is not None:
            with open(path + ".json", "w") as f:
                json.dump(metadata, f)
        self._gc()
        return path

    def steps(self):
        out = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template=None, step: Optional[int] = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree = load_pytree(self._path(step), template)
        meta_path = self._path(step) + ".json"
        metadata = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        return tree, step, metadata

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            for suffix in ("", ".json"):
                p = self._path(s) + suffix
                if os.path.exists(p):
                    os.unlink(p)
