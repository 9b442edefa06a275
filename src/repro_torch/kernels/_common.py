"""What every kernel wrapper shares: launch counts and input checks.

:data:`LAUNCH_COUNTS` holds one entry per hand-written kernel.  A wrapper
adds one to its entry where it launches its kernel on the card, and
nowhere else: a CPU tensor runs the plain version and counts nothing.
:data:`THREAD_LAUNCHES` splits the same launches by the name of the
thread that made them: the streaming cohort server launches from its
callers' threads and from its background solver's.
"""

from __future__ import annotations

import threading

import torch

MAX_D = 32               # widest point the kernels hold in registers

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCH_COUNTS = {"quantized_cross_affinity": 0, "nystrom_colsum": 0,
                 "nystrom_gram": 0, "nystrom_extension": 0,
                 "panel_matmul": 0, "pairwise_sq_dists": 0,
                 "rbf_affinity": 0, "rbf_cross_affinity": 0,
                 "flash_attention": 0, "ssd_chunk": 0}
#: {thread name: {kernel: launches}} since the last reset
THREAD_LAUNCHES: dict = {}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCH_COUNTS:
            LAUNCH_COUNTS[name] = 0
        THREAD_LAUNCHES.clear()


def launched(name: str) -> None:
    thread = threading.current_thread().name
    with _COUNT_LOCK:
        LAUNCH_COUNTS[name] += 1
        counts = THREAD_LAUNCHES.setdefault(thread,
                                            dict.fromkeys(LAUNCH_COUNTS, 0))
        counts[name] += 1


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (``FakeTensorMode``'s: a shape, a
    dtype and a device, no data), as the dry run runs a step on."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def check_tensors(name, *, dtypes=(torch.float32,), contiguous=True,
                  fake=False, **tensors) -> torch.device:
    """Tensors of one of ``dtypes`` on one CPU or CUDA device, contiguous
    on CUDA unless ``contiguous=False``; returns that device.  ``None``
    entries are skipped.  A fake tensor raises (no wrapper hands one to
    a kernel), unless ``fake``: then fake tensors on one device of any
    kind pass, for a wrapper's shape-only route."""
    given = {k: t for k, t in tensors.items() if t is not None}
    fakes = [k for k, t in given.items() if is_fake(t)]
    if fakes and not (fake and len(fakes) == len(given)):
        raise ValueError(f"{name}: {fakes} are fake tensors, which the "
                         f"kernel cannot read")
    for k, t in given.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {k} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype not in dtypes:
            allowed = " or ".join(str(d).replace("torch.", "")
                                  for d in dtypes)
            raise TypeError(f"{name}: {k} must be {allowed}, got {t.dtype}")
    devices = {t.device for t in given.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on different devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda") and not fakes:
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and contiguous:
        for k, t in given.items():
            if not t.is_contiguous():
                raise ValueError(f"{name}: {k} must be contiguous")
    return dev


def differentiated(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode is on and
    one of them requires grad.  The CUDA kernels have no backward, so
    the model code takes its plain path on such a call (as the JAX
    package's training does, which reaches no Pallas kernel), and the
    wrappers refuse one on the card."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_no_grad(name, *tensors) -> None:
    """Raise on a differentiated call of a kernel (:func:`differentiated`):
    its output would cut the autograd graph."""
    if differentiated(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; a differentiated "
            f"call (grad mode on and an input that requires grad) takes "
            f"the model's plain path")


def check_block(name, label, value) -> None:
    if int(value) < 1:
        raise ValueError(f"{name}: {label}={value} must be >= 1")


def check_points(name, x, z):
    """(n, m, d) of the point sets x (n, d) and z (m, d)."""
    if x.dim() != 2 or z.dim() != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and z "
                         f"{tuple(z.shape)} must be (n, d) and (m, d)")
    n, d = x.shape
    m = z.shape[0]
    return n, m, d


def check_kernel_shape(name, n, m, d):
    if n < 1 or m < 1:
        raise ValueError(f"{name}: the CUDA kernel needs n >= 1 and m >= 1, "
                         f"got n={n}, m={m}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: the CUDA kernel takes 1 <= d <= "
                         f"{MAX_D}, got d={d}")


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
