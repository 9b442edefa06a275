"""Fixture: kernel wrappers done right (parsed, not run).

A CPU tensor runs the plain version, a CUDA tensor the kernel (checked,
then counted), a fake tensor a shape-only route that never touches lib.
"""
import torch

from kernels_good import _build, ref
from kernels_good._common import is_fake, launched


def kernel_work(name, device, ops, nbytes):
    return None


def scale(x, alpha):
    name = "scale"
    if x.device.type == "cpu":
        return ref.scale_ref(x, alpha)
    lib = _build.library()
    out = torch.empty_like(x)
    err = lib.rt_scale(x.data_ptr(), out.data_ptr(), float(alpha),
                       x.numel(), 0)
    _build.check(err, name)
    launched(name)
    return out


def shaped(x, strides):
    name = "shaped"
    fake = is_fake(x)
    if x.device.type == "cpu" and not fake:
        return ref.shaped_ref(x)
    if fake:
        kernel_work(name, x.device, 0, 2 * x.numel())
        return torch.empty_like(x)
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.rt_shaped(x.data_ptr(), out.data_ptr(), x.numel(), strides,
                        0)
    _build.check(err, name)
    launched("shaped")
    return out
