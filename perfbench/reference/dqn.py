"""Plain reference of the cluster policy's Q-network and its TD update.

The Q-network is an MLP, ReLU between layers, with weights drawn as
N(0, 1) / sqrt(fan_in) from a CPU generator seeded with the policy seed
and zero biases (paper section 3.3, as the policy documents it).  Its
update is one minibatch of the mean squared TD error
``r + gamma Q_target(s', a*) - Q(s, a)``, with ``a*`` chosen by the
current network (double DQN) or the target, and SGD with momentum 0.9
and no dampening; the target network is a copy taken every
``target_sync_every`` updates.  The gradient is worked out by hand, so
that every product's precision is the caller's: float64 for the judge,
or (``tf32``, the control) float32 with each product's operands rounded
to TF32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def initial_weights(seed: int, dims: Sequence[int]):
    """[(weight (out, in), bias (out,))] of the initial network."""
    gen = torch.Generator().manual_seed(int(seed))
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((b, a), generator=gen) / np.sqrt(a)
        layers.append((w, torch.zeros(b)))
    return layers


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away), as a TF32 product reads its operands."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a, b, tf32: bool):
    return to_tf32(a) @ to_tf32(b) if tf32 else a @ b


def forward(layers, x, *, tf32: bool = False):
    """(action values, [input, each layer's output]) of a batch."""
    hs = [x]
    for i, (w, b) in enumerate(layers):
        x = _mm(x, w.T, tf32) + b
        if i < len(layers) - 1:
            x = torch.relu(x)
        hs.append(x)
    return x, hs


def td_gradient(layers, target, batch: dict, gamma: float, double: bool,
                *, tf32: bool = False):
    """(loss, [(dW, db)]) of the mean squared TD error of ``batch`` (the
    target side carries no gradient)."""
    s, a, r, s2, done = (batch[key] for key in ("s", "a", "r", "s2",
                                                "done"))
    rows = torch.arange(len(a))
    q, hs = forward(layers, s, tf32=tf32)
    q_sa = q[rows, a]
    q_next_t, _ = forward(target, s2, tf32=tf32)
    chooser = forward(layers, s2, tf32=tf32)[0] if double else q_next_t
    y = r + gamma * (1.0 - done) * q_next_t[rows, torch.argmax(chooser, 1)]
    loss = torch.mean((q_sa - y) ** 2)
    g = torch.zeros_like(q)
    g[rows, a] = 2.0 * (q_sa - y) / len(a)
    grads = []
    for i in reversed(range(len(layers))):
        grads.append((_mm(g.T, hs[i], tf32), g.sum(0)))
        if i:
            g = _mm(g, layers[i][0], tf32) * (hs[i] > 0)
    return loss, grads[::-1]
