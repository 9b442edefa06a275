"""The cohort engine's device mesh: a tuple of devices.

Port of the cohort half of the JAX package's ``launch/mesh.py``.  The JAX
engine shards client rows over a 1-D ``("clients",)`` mesh with
``shard_map`` from one Python process; here one process places row
shards on a tuple of ``torch.device``s (``cohort/sharded.py``) and sums
the two per-solve partials on the first device in shard order.  A tuple
may repeat a device: ``(cpu,) * 8`` or ``(cuda:0,) * 4`` is the
counterpart of ``--xla_force_host_platform_device_count``, and runs the
padding, the masks and both cross-shard sums on one device.

The TPU production meshes (``make_production_mesh``, ``make_test_mesh``)
have no counterpart: the port targets one host.

Functions only: importing this module touches no device.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from repro_torch.device import resolve_device

Mesh = Tuple[torch.device, ...]


def as_mesh(devices: Iterable) -> Mesh:
    """``devices`` as a cohort mesh, checked.

    Every entry must be the CPU, or every entry a visible CUDA device
    (an index-less ``"cuda"`` takes the current one).  Raises, naming the
    devices, on an empty tuple, on a mix of CPU and CUDA and on a CUDA
    index the process cannot see.
    """
    mesh = tuple(torch.device(d) for d in devices)
    names = [str(d) for d in mesh]
    if not mesh:
        raise ValueError("a cohort mesh needs at least one device")
    kinds = {d.type for d in mesh}
    if kinds - {"cpu", "cuda"}:
        raise ValueError(f"a cohort mesh holds CPU or CUDA devices, got "
                         f"{names}")
    if len(kinds) != 1:
        raise ValueError(f"a cohort mesh cannot mix the CPU and CUDA "
                         f"devices: {names}")
    if kinds == {"cuda"}:
        mesh = tuple(resolve_device(d) for d in mesh)
        visible = torch.cuda.device_count()
        bad = [str(d) for d in mesh if d.index >= visible]
        if bad:
            raise ValueError(f"cohort mesh {names}: {bad} not among the "
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
            f"make_cohort_mesh: {n} CUDA devices asked for, "
            f"{visible} visible: "
            f"{[f'cuda:{i}' for i in range(visible)]}")
    others = [torch.device("cuda", i) for i in range(visible)
              if i != first.index]
    return as_mesh((first, *others[:n - 1]))


def device_count_available(n: int) -> bool:
    """Whether ``n`` CUDA devices are visible."""
    return torch.cuda.device_count() >= n
