"""Fixture: kernel wrappers breaking each rule (parsed, not run).

A trailing ``# expect: <rule>`` marks each line the port's lint must flag.
"""
import torch

from kernels_bad import _build, ref
from kernels_bad._common import is_fake, launched


def kernel_work(name, device, ops, nbytes):
    return None


def no_oracle(x):                                  # expect: kernel-ref-oracle
    if x.device.type == "cpu":
        return ref.no_oracle_ref(x)
    lib = _build.library()
    out = torch.empty_like(x)
    err = lib.rt_plain(x.data_ptr(), out.data_ptr(), x.numel(), 0)
    _build.check(err, "no_oracle")
    launched("no_oracle")
    return out


def no_cpu_route(x):                               # expect: kernel-cpu-route
    lib = _build.library()
    out = torch.empty_like(x)
    err = lib.rt_plain(x.data_ptr(), out.data_ptr(), x.numel(), 0)
    _build.check(err, "no_cpu_route")
    launched("no_cpu_route")
    return out


def fallback(x):
    if x.device.type == "cpu":
        return ref.fallback_ref(x)
    out = torch.empty_like(x)
    try:
        lib = _build.library()
        err = lib.rt_plain(x.data_ptr(), out.data_ptr(), x.numel(), 0)
        _build.check(err, "fallback")
    except RuntimeError:                           # expect: kernel-no-fallback
        return ref.fallback_ref(x.cpu()).to(x.device)
    launched("fallback")
    return out


def unchecked(x):
    if x.device.type == "cpu":
        return ref.unchecked_ref(x)
    lib = _build.library()
    out = torch.empty_like(x)
    lib.rt_plain(x.data_ptr(), out.data_ptr(), x.numel(), 0)  # expect: kernel-no-fallback
    launched("unchecked")                          # expect: kernel-no-fallback
    return out


def miscounted(x):
    if x.device.type == "cpu":
        return ref.miscounted_ref(x)
    lib = _build.library()
    out = torch.empty_like(x)
    err = lib.rt_plain(x.data_ptr(), out.data_ptr(), x.numel(), 0)  # expect: kernel-no-fallback
    _build.check(err, "miscounted")
    launched("missing_key")                        # expect: kernel-no-fallback
    return out


def fake_leak(x):                                  # expect: kernel-no-fallback
    fake = is_fake(x)
    if x.device.type == "cpu" and not fake:
        return ref.fake_leak_ref(x)
    lib = _build.library()
    if fake:
        kernel_work("fake_leak", x.device, 0, 0)
        lib.rt_plain(0, 0, 0, 0)                   # expect: kernel-no-fallback
        return torch.empty_like(x)
    out = torch.empty_like(x)
    err = lib.rt_plain(x.data_ptr(), out.data_ptr(), x.numel(), 0)
    _build.check(err, "fake_leak")
    launched("fake_leak")
    return out


def wrong_arity(x):
    if x.device.type == "cpu":
        return ref.wrong_arity_ref(x)
    lib = _build.library()
    out = torch.empty_like(x)
    err = lib.rt_plain(x.data_ptr(), out.data_ptr(), x.numel(), 1, 0)  # expect: kernel-abi
    _build.check(err, "wrong_arity")
    launched("wrong_arity")
    return out


def early_count(x):
    if x.device.type == "cpu":
        launched("early_count")                    # expect: kernel-no-fallback
        return ref.early_count_ref(x)
    lib = _build.library()
    out = torch.empty_like(x)
    err = lib.rt_plain(x.data_ptr(), out.data_ptr(), x.numel(), 0)
    _build.check(err, "early_count")
    launched("early_count")
    return out
