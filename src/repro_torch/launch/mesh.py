"""Device meshes of the port: one process driving a tuple of devices.

Port of the JAX package's ``launch/mesh.py``.  There is no
``torch.distributed``: one Python process places shards on a tuple of
``torch.device``s and sums partials on the first device in device order,
as the JAX package drives its mesh from one process.  A tuple may repeat
a device: ``(cpu,) * 8`` or ``(cuda:0,) * 4`` is the counterpart of
``--xla_force_host_platform_device_count``, and runs every cut, copy
and cross-device sum on one device.

* ``make_cohort_mesh``: the cohort engine's 1-D mesh, a plain tuple of
  devices (``cohort/sharded.py`` spreads client rows over it).
* ``make_test_mesh``: a :class:`NamedMesh` with the JAX package's axis
  names and defaults, ``("data", "model")`` or ``("pod", "data",
  "model")``, that ``models/sharding.py`` lays parameters out on and LM
  training runs over (``launch/steps.py::make_train_step``): each data
  coordinate a replica (:attr:`NamedMesh.replicas`), its ``model``
  devices the ranks of tensor parallelism.

``make_production_mesh`` (the TPU v5e 16x16 pod, 2 pods multi-pod) is
not ported: the port targets the cards of one host.

Functions only: importing this module touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

import torch

from repro_torch.device import resolve_device

Mesh = Tuple[torch.device, ...]


def as_mesh(devices: Iterable) -> Mesh:
    """``devices`` as a mesh, checked.

    Every entry must be the CPU, or every entry a visible CUDA device
    (an index-less ``"cuda"`` takes the current one).  Raises, naming the
    devices, on an empty tuple, on a mix of CPU and CUDA and on a CUDA
    index the process cannot see.
    """
    mesh = tuple(torch.device(d) for d in devices)
    names = [str(d) for d in mesh]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    kinds = {d.type for d in mesh}
    if kinds - {"cpu", "cuda"}:
        raise ValueError(f"a mesh holds CPU or CUDA devices, got "
                         f"{names}")
    if len(kinds) != 1:
        raise ValueError(f"a mesh cannot mix the CPU and CUDA "
                         f"devices: {names}")
    if kinds == {"cuda"}:
        mesh = tuple(resolve_device(d) for d in mesh)
        visible = torch.cuda.device_count()
        bad = [str(d) for d in mesh if d.index >= visible]
        if bad:
            raise ValueError(f"mesh {names}: {bad} not among the "
                             f"{visible} visible CUDA devices")
    return mesh


def make_cohort_mesh(num_devices: int | None = None, *, device=None) -> Mesh:
    """The 1-D mesh the sharded cohort engine spreads client rows over.

    On the card (``device`` None or CUDA): ``num_devices`` of the visible
    CUDA devices (default all), ``device`` first and the others in index
    order.  ``device="cpu"``: ``num_devices`` copies of the CPU (default
    one).  Raises when more CUDA devices are asked for than are visible.
    """
    first = resolve_device(device)
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"num_devices={num_devices} must be >= 1")
    if first.type == "cpu":
        return (first,) * (num_devices or 1)
    visible = torch.cuda.device_count()
    n = num_devices or visible
    if n > visible:
        raise ValueError(
            f"a mesh of {n} CUDA devices asked for, "
            f"{visible} visible: "
            f"{[f'cuda:{i}' for i in range(visible)]}")
    others = [torch.device("cuda", i) for i in range(visible)
              if i != first.index]
    return as_mesh((first, *others[:n - 1]))


def device_count_available(n: int) -> bool:
    """Whether ``n`` CUDA devices are visible."""
    return torch.cuda.device_count() >= n


@dataclasses.dataclass(frozen=True)
class NamedMesh:
    """A mesh with named axes: ``devices`` in row-major order over
    ``axis_names`` of ``sizes`` (the first axis slowest)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Mesh

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if math.prod(self.sizes) != len(self.devices):
            raise ValueError(f"a {dict(zip(self.axis_names, self.sizes))} "
                             f"mesh needs {math.prod(self.sizes)} devices, "
                             f"got {len(self.devices)}")

    @property
    def shape(self) -> dict:
        """Each axis name's size, as the JAX ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def ranks(self) -> int:
        """The ``model`` size M: the devices of one replica."""
        return self.shape.get("model", 1)

    @property
    def replicas(self) -> Tuple[Mesh, ...]:
        """The data-parallel replicas, one per (pod, data) coordinate in
        row-major order, each the tuple of its M ``model`` ranks'
        devices (``model`` is the innermost axis, as in
        ``jax.make_mesh``)."""
        M = self.ranks
        return tuple(self.devices[r:r + M]
                     for r in range(0, len(self.devices), M))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 1, *,
                   device=None, devices: Optional[Iterable] = None
                   ) -> NamedMesh:
    """A ``(data, model)`` mesh, or ``(pod, data, model)`` with ``pod``
    larger than 1, over ``pod * data * model`` devices.

    ``devices`` names them explicitly (a tuple may repeat a device:
    ``(cuda:0,) * 4`` runs a 4-way mesh on one card).  Otherwise, on the
    card (``device`` None or CUDA): that many visible CUDA devices,
    ``device`` first and the others in index order, raising when fewer
    are visible; ``device="cpu"``: that many copies of the CPU.
    """
    names = ("pod", "data", "model") if pod > 1 else ("data", "model")
    sizes = (pod, data, model) if pod > 1 else (data, model)
    if min(sizes) < 1:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} must be >= 1")
    n = math.prod(sizes)
    if devices is not None:
        if device is not None:
            raise ValueError("pass device or devices, not both")
        return NamedMesh(names, sizes, as_mesh(devices))
    return NamedMesh(names, sizes, make_cohort_mesh(n, device=device))
