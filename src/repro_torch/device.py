"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` means ``"cuda"``.  A CUDA device without a visible GPU
    raises instead of carrying on quietly on the CPU; pass
    ``device="cpu"`` to run the plain PyTorch path there.  A CUDA device
    without an index gets the calling thread's current one, so an entry
    point keeps its card when another thread (a background solver) runs
    its work: each thread has its own current device.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
