"""Fixture: every torch purity/RNG rule violated (parsed, not run).

A trailing ``# expect: <rule>`` marks each line the port's lint must
flag, once per rule named; no other line may be flagged.
"""
import random

import numpy as np
import torch
from torch.func import grad, vmap

_GLOBAL = torch.randn(3)                     # expect: torch-global-rng


def _loss(w, x):
    scale = float(x.sum())                   # expect: torch-host-sync
    return (w * x).sum() * scale


def _helper(x):
    return x.item()                          # expect: torch-host-sync


def batched(w, xs):
    g = vmap(grad(_loss), in_dims=(None, 0))(w, xs)
    return g + vmap(lambda x: _helper(x) + np.asarray(x).sum())(xs)  # expect: torch-host-sync


def global_draws(w):
    a = torch.rand(3)                        # expect: torch-global-rng
    b = torch.randint(0, 4, (3,))            # expect: torch-global-rng
    w.normal_()                              # expect: torch-global-rng
    torch.nn.init.uniform_(w)                # expect: torch-global-rng
    c = np.random.normal(size=3)             # expect: torch-global-rng
    d = random.random()                      # expect: torch-global-rng
    return a, b, c, d


def reseed():
    torch.manual_seed(0)                     # expect: torch-global-rng
    torch.cuda.manual_seed_all(0)            # expect: torch-global-rng


def constant_seeds(n):
    g = torch.Generator().manual_seed(7)     # expect: torch-constant-seed
    rng = np.random.default_rng(0)           # expect: torch-constant-seed
    return torch.rand(n, generator=g), rng.normal(size=n)


def seed_reuse(seed, n):
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)  # expect: torch-seed-reuse
    return torch.rand(n, generator=g1) + torch.rand(n, generator=g2)


class _Net(torch.nn.Module):
    def forward(self, x):
        return x * 2


def cnn_apply(model, params, x):
    return torch.func.functional_call(model, params, (x,))


def cnn_loss(model, params, x):
    return cnn_apply(model, params, x).mean()


def evaluate(model, params, x):
    with torch.no_grad():
        return cnn_loss(model, params, x)


def round_boundary(model, params, x):
    loss = evaluate(model, params, x)
    first = float(loss)                      # expect: torch-blocking-sync
    step = torch.compile(_Net())
    out = step(x)
    return first, out.tolist()               # expect: torch-blocking-sync


class _Square(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x, bool(x.any())          # expect: torch-host-sync

    @staticmethod
    def backward(ctx, g, _):
        (x,) = ctx.saved_tensors
        return 2 * x * g
