"""The paper's CNN classifier (DQRE §4.2, Fig. 4) in PyTorch.

Port of the JAX package's ``models/cnn.py``: four 3x3 conv blocks with
24/18/12/6 channels, one *stochastic* 2x2 pooling layer after the second
conv, and two fully-connected layers (128 hidden units).  This is the
model the federated clients train.

Layouts follow the JAX package at the public functions: images come in
as (B, H, W, C), and the features reach ``fc1`` flattened in NHWC order,
so converting JAX weights is a transpose per leaf (``repro_torch.convert``).
Inside, the convolutions run on an NCHW view of the images.

Stochastic pooling draws no random numbers itself: train mode takes its
Gumbel noise as an input (:func:`gumbel_noise` draws it from a CPU
generator), so a round on the card and on the CPU see the same noise,
and a test can inject the JAX package's draws.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CHANNELS = (24, 18, 12, 6)
HIDDEN = 128


def stochastic_pool(x, noise=None):
    """2x2 stochastic pooling (Zeiler & Fergus) of (B, C, H, W) maps.

    Train mode (``noise`` given, (B, C, H//2, W//2, 4) Gumbel samples)
    picks one activation per window with probability proportional to its
    relu'd magnitude, as argmax(log(max(p, 1e-9)) + noise); eval mode
    returns the probability-weighted mean.  Window entry t is (dy, dx) =
    divmod(t, 2); an odd H or W is cropped.
    """
    b, c, h, w = x.shape
    hp, wp = h // 2, w // 2
    x = x[:, :, : hp * 2, : wp * 2]
    win = x.reshape(b, c, hp, 2, wp, 2).permute(0, 1, 2, 4, 3, 5)
    win = win.reshape(b, c, hp, wp, 4)
    pos = torch.relu(win)
    denom = pos.sum(-1, keepdim=True)
    probs = torch.where(denom > 0, pos / torch.clamp_min(denom, 1e-9),
                        torch.full_like(pos, 0.25))
    if noise is None:
        return (probs * win).sum(-1)
    idx = torch.argmax(torch.log(torch.clamp_min(probs, 1e-9)) + noise,
                       dim=-1)
    return torch.gather(win, -1, idx[..., None])[..., 0]


def pool_noise_shape(batch: int, image_size: int):
    """Per-client shape of the pooling noise: (B, C1, H/2, W/2, 4)."""
    half = image_size // 2
    return (batch, CHANNELS[1], half, half, 4)


def gumbel_noise(seed: int, shape, device):
    """Standard Gumbel draws from a CPU generator seeded ``seed``.

    Returns ``draw(step)``, which draws the next ``shape`` block on the
    CPU and moves it to ``device``; call it once per step, in order.
    """
    gen = torch.Generator().manual_seed(int(seed))
    tiny = torch.finfo(torch.float32).tiny

    def draw(step: int):
        del step                     # the stream is consumed in order
        u = torch.rand(shape, generator=gen).clamp_(min=tiny)
        return (-torch.log(-torch.log(u))).to(device)

    return draw


class CNN(nn.Module):
    """The federated clients' model; ``forward(x, noise=None)`` -> logits.

    Initialized as the JAX package's ``cnn_init``: conv weights N(0, 1) /
    sqrt(9·c_in), dense weights N(0, 1) / sqrt(fan_in), zero biases,
    drawn from the CPU ``generator``.
    """

    def __init__(self, *, in_channels: int = 1, num_classes: int = 10,
                 image_size: int = 28, generator=None):
        super().__init__()
        chans = (in_channels, *CHANNELS)
        self.image_size = image_size
        for i in range(4):
            setattr(self, f"conv{i}", nn.Conv2d(chans[i], chans[i + 1], 3,
                                                padding=1))
        feat = (image_size // 2) ** 2 * chans[-1]
        self.fc1 = nn.Linear(feat, HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, num_classes)
        with torch.no_grad():
            for layer in (*self.convs(), self.fc1, self.fc2):
                fan_in = layer.weight[0].numel()
                layer.weight.copy_(torch.randn(layer.weight.shape,
                                               generator=generator)
                                   / np.sqrt(fan_in))
                layer.bias.zero_()

    def convs(self):
        return [getattr(self, f"conv{i}") for i in range(4)]

    def forward(self, x, noise=None):
        """x: (B, H, W, C) images -> (B, num_classes) logits."""
        h = x.permute(0, 3, 1, 2)                       # NCHW view
        c0, c1, c2, c3 = self.convs()
        h = torch.relu(c0(h))
        h = torch.relu(c1(h))
        h = stochastic_pool(h, noise)
        h = torch.relu(c2(h))
        h = torch.relu(c3(h))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
        h = torch.relu(self.fc1(h))
        return self.fc2(h)


def cnn_apply(model, x, *, noise=None, params=None):
    """Logits of ``model`` on (B, H, W, C) images; ``params`` (a state
    dict) replaces the module's own parameters (``functional_call``)."""
    if params is None:
        return model(x, noise)
    return torch.func.functional_call(model, params, (x, noise))


def cnn_loss(model, batch, noise=None, *, params=None):
    """(mean cross-entropy, logits) on ``batch = {"x", "y"}``."""
    logits = cnn_apply(model, batch["x"], noise=noise, params=params)
    return F.cross_entropy(logits, batch["y"]), logits
