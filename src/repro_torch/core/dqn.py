"""Deep-Q network with current + target networks (paper §3.3).

Two MLPs — the *current* Q function and a delayed *target* copy — trained
on the TD error ``r + γ·Q(s', a*; θ⁻) − Q(s, a; θ)`` (double-DQN action
selection optional), ε-greedy exploration, a uniform replay buffer and a
periodic hard target sync.  The update is SGD with momentum 0.9 and no
dampening, the JAX package's ``mu = 0.9·mu + g; p -= lr·mu``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device


@dataclasses.dataclass
class DQNConfig:
    state_dim: int
    num_actions: int
    hidden: Tuple[int, ...] = (128, 128)
    gamma: float = 0.95
    lr: float = 1e-3
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 200
    target_sync_every: int = 10
    buffer_size: int = 4096
    batch_size: int = 64
    double_dqn: bool = True


class QNet(nn.Module):
    """MLP of ``nn.Linear`` layers with ReLU between them.

    Initialized like the JAX package's ``dense_init``: weights
    N(0, 1)/sqrt(fan_in) drawn from ``generator``, zero biases.
    """

    def __init__(self, cfg: DQNConfig, *, generator=None):
        super().__init__()
        dims = (cfg.state_dim, *cfg.hidden, cfg.num_actions)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for layer in self.layers:
                w = torch.randn(layer.weight.shape, generator=generator)
                layer.weight.copy_(w / np.sqrt(layer.in_features))
                layer.bias.zero_()

    def forward(self, s):
        h = s
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h


def td_loss(net: QNet, target: QNet, batch: dict, gamma: float,
            double_dqn: bool):
    """Mean squared TD error; the target side carries no gradient."""
    q = net(batch["s"])
    q_sa = q.gather(1, batch["a"][:, None])[:, 0]
    with torch.no_grad():
        q_next_t = target(batch["s2"])
        chooser = net(batch["s2"]) if double_dqn else q_next_t
        a_star = torch.argmax(chooser, dim=1)
        q_next = q_next_t.gather(1, a_star[:, None])[:, 0]
        y = batch["r"] + gamma * (1.0 - batch["done"]) * q_next
    return torch.mean((q_sa - y) ** 2)


class ReplayBuffer:
    """Uniform ring-buffer replay (host-side numpy)."""

    def __init__(self, capacity: int, state_dim: int):
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity,), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.size = 0
        self.ptr = 0

    def add(self, s, a, r, s2, done):
        i = self.ptr
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.done[i] = s2, float(done)
        self.ptr = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int) -> dict:
        """A minibatch of numpy arrays, drawn with replacement by ``rng``."""
        idx = rng.integers(0, self.size, size=min(batch, self.size))
        return {"s": self.s[idx], "a": self.a[idx], "r": self.r[idx],
                "s2": self.s2[idx], "done": self.done[idx]}


class DQNAgent:
    """Current + target Q networks with ε-greedy selection."""

    def __init__(self, cfg: DQNConfig, *, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.net = QNet(cfg, generator=gen).to(self.device)
        self.target = copy.deepcopy(self.net)
        self.target.requires_grad_(False)
        self.opt = torch.optim.SGD(self.net.parameters(), lr=cfg.lr,
                                   momentum=0.9, dampening=0.0)
        self.buffer = ReplayBuffer(cfg.buffer_size, cfg.state_dim)
        self.steps = 0
        self.train_calls = 0
        self._last_loss = 0.0              # device scalar after training

    # -- acting -----------------------------------------------------------
    def epsilon(self) -> float:
        c = self.cfg
        frac = min(self.steps / max(c.eps_decay_steps, 1), 1.0)
        return float(c.eps_start + (c.eps_end - c.eps_start) * frac)

    def q_values(self, state) -> np.ndarray:
        s = torch.as_tensor(np.asarray(state, np.float32),
                            device=self.device)
        with torch.no_grad():
            return self.net(s[None])[0].cpu().numpy()

    def act(self, rng: np.random.Generator, state) -> int:
        self.steps += 1
        if rng.random() < self.epsilon():
            return int(rng.integers(self.cfg.num_actions))
        return int(np.argmax(self.q_values(state)))

    # -- learning ----------------------------------------------------------
    def observe(self, s, a, r, s2, done=False):
        self.buffer.add(np.asarray(s, np.float32), a, r,
                        np.asarray(s2, np.float32), done)

    def batch_tensors(self, batch: dict) -> dict:
        out = {k: torch.as_tensor(v, device=self.device)
               for k, v in batch.items()}
        out["a"] = out["a"].long()
        return out

    def train_step(self, rng: np.random.Generator):
        """One TD minibatch; returns the loss as a DEVICE scalar.

        No host sync here: the serving path runs this under its select
        lock.  :attr:`last_loss` materializes it on demand.
        """
        if self.buffer.size < 8:
            return 0.0
        batch = self.batch_tensors(
            self.buffer.sample(rng, self.cfg.batch_size))
        loss = td_loss(self.net, self.target, batch, self.cfg.gamma,
                       self.cfg.double_dqn)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.train_calls += 1
        if self.train_calls % self.cfg.target_sync_every == 0:
            self.target.load_state_dict(self.net.state_dict())
        self._last_loss = loss.detach()
        return self._last_loss

    @property
    def last_loss(self) -> float:
        """Most recent TD loss, materialized on demand (syncs here)."""
        return float(self._last_loss)
