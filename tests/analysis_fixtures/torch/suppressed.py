"""Fixture: torch lint violations silenced by inline suppressions."""
import numpy as np
import torch


def fixed_start(n):
    # a deliberately fixed range start; reproducibility is the point
    # repro-lint: ignore[torch-constant-seed]
    g = torch.Generator().manual_seed(0)
    return torch.randn(n, generator=g)


def same_line(n):
    return np.random.default_rng(1).normal(size=n)  # repro-lint: ignore[torch-constant-seed]


def blanket(n):
    torch.manual_seed(n)  # repro-lint: ignore
    return n


def wrong_rule_listed(n):
    return torch.rand(n)  # repro-lint: ignore[torch-constant-seed]
