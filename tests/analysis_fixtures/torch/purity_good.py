"""Fixture: the torch purity/RNG rules' shapes done right (parsed, not run).

Every draw names its generator, seeds enter as parameters and derive
before reuse, transformed code reads only sizes, and a float() of a
plain helper's result is not a blocking read.
"""
import numpy as np
import torch
from torch.func import grad, vmap

_RNG = np.random.default_rng(0)          # module level: one stream


def _loss(w, x):
    n = int(x.shape[0])                  # a size, not a value
    return (w * x).sum() / max(len(x), n)


def batched(w, xs):
    return vmap(grad(_loss), in_dims=(None, 0))(w, xs)


def draws(w, gen, rng):
    a = torch.rand(3, generator=gen)
    w.normal_(generator=gen)
    torch.nn.init.uniform_(w, generator=gen)
    torch.nn.init.zeros_(w)
    seq = np.random.SeedSequence([1, 2])
    return a, rng.normal(size=3), np.random.default_rng(seq)


def fresh_seeds(seed, n):
    g1 = torch.Generator().manual_seed(seed)
    seed = seed + 1
    g2 = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)    # numpy's stream, not torch's
    return torch.rand(n, generator=g1) + torch.rand(n, generator=g2), rng


def seeded_by_caller(seed, n):
    return torch.randn(n, generator=torch.Generator().manual_seed(seed))


def plain_helper(xs):
    return sum(xs) / len(xs)


def host_values(xs, t):
    mean = plain_helper(xs)
    rate = float(mean)                   # a plain helper's result
    return rate, t.item()                # a tensor read outside a transform
