"""Plain reference of one cohort solve: Nystrom spectral clustering.

Written from the method (Fowlkes et al., 2004, with the engine's degree
normalization and the dense landmark eigensolve), in plain PyTorch, with no
kernel, cache or batching, and nothing imported from the program under
test.  It works out again from an embedding table what the engine
derives from it: the content fingerprint and the per-solve random
generators it seeds, the landmarks, the RBF bandwidth (median
heuristic), the drift sketch and so the warm-or-cold decision, then
W = A(z, z), its pseudo-inverse square root, the degree direction, the
rotated Gram, the top-k eigenpairs, the row-normalized extension and
k-means.

``dtype`` sets the precision: ``torch.float64`` is the judge;
``torch.float32`` with ``tf32=True`` is the control (the same steps one
precision below the configuration's float32, matrix products in TF32).
The (n, m) cross-affinity is never held whole: rows go in blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

EPS = 1e-12
GAMMA_SAMPLE_ROWS = 4096       # rows of the median heuristic's sample
ISQRT_CLIP = 1e-6              # eigenvalues under this * max count as 0
BLOCK_ROWS = 1 << 16           # rows of a block of the cross-affinity


def fingerprint(table: np.ndarray) -> bytes:
    """sha1 of the table's bytes and its shape."""
    h = hashlib.sha1(np.ascontiguousarray(table).tobytes())
    h.update(str(table.shape).encode())
    return h.digest()


def solve_generators(seed: int, fp: bytes):
    """(landmarks, solver, k-means) CPU generators of one solve, seeded
    from the engine seed and the fingerprint's first four bytes."""
    seq = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int.from_bytes(fp[:4], "little")])
    return tuple(torch.Generator().manual_seed(int(s))
                 for s in seq.generate_state(3, np.uint64))


def sketch_sign(seed: int, n: int) -> np.ndarray:
    """The drift sketch's +-1 row weights."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    return rng.choice(np.array([-1.0, 1.0], np.float32), size=n)


def sketch(table: np.ndarray, sign: np.ndarray) -> np.ndarray:
    """Column means, column deviations and the sign-weighted row mean."""
    return np.concatenate([table.mean(axis=0), table.std(axis=0),
                           (sign[:, None] * table).mean(axis=0)])


def drift(current: np.ndarray, baseline: Optional[np.ndarray]) -> float:
    if baseline is None:
        return float("inf")
    return float(np.linalg.norm(current - baseline)
                 / (np.linalg.norm(baseline) + EPS))


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (the control) or in full precision."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def sq_dists(x, y):
    """(n, m) squared distances, |x|^2 + |y|^2 - 2 x.y, clamped at 0."""
    xn = (x * x).sum(-1)[:, None]
    yn = (y * y).sum(-1)[None, :]
    return torch.clamp_min(xn + yn - 2.0 * (x @ y.T), 0.0)


def median_gamma(x, z) -> float:
    """1 / (2 median of the positive squared distances) between the
    table's first rows and the landmarks; an even count averages the two
    middle values."""
    d2 = sq_dists(x[:GAMMA_SAMPLE_ROWS], z)
    vals = torch.sort(d2[d2 > 0]).values
    if vals.numel() == 0:
        return 0.5
    c = vals.numel()
    med = 0.5 * vals[(c - 1) // 2] + 0.5 * vals[c // 2]
    return float(1.0 / torch.clamp_min(2.0 * med, EPS))


def top_eigh(a, r: int):
    """Top-r eigenpairs of symmetric ``a``, descending."""
    ew, uw = torch.linalg.eigh(a)
    return ew.flip(0)[:r], uw.flip(1)[:, :r]


def isqrt(evals, evecs):
    """U diag(1/sqrt(l)) U^T with eigenvalues under ISQRT_CLIP * max
    dropped."""
    good = evals > ISQRT_CLIP * evals.max()
    inv = torch.where(good, 1.0 / torch.clamp_min(evals, EPS),
                      torch.zeros_like(evals))
    return (evecs * torch.sqrt(inv)[None, :]) @ evecs.T


def kmeans(gen, y, k: int, iters: int = 25):
    """k-means++ seeding (first center uniform, then D^2 by inverse CDF
    of the generator's uniforms) and ``iters`` Lloyd steps; an emptied
    cluster keeps its center."""
    n = y.shape[0]
    first = int(torch.randint(n, (), generator=gen))
    draws = torch.rand(max(k - 1, 0), generator=gen).to(y.device)
    centers = torch.zeros((k, y.shape[1]), dtype=y.dtype, device=y.device)
    centers[0] = y[first]
    dmin = sq_dists(y, centers[:1])[:, 0]
    for i in range(1, k):
        w = dmin / torch.clamp_min(dmin.sum(), EPS)
        cdf = torch.cumsum(w.double(), 0)
        idx = torch.searchsorted(cdf, (draws[i - 1].double() * cdf[-1])
                                 .reshape(1), right=True)
        idx = torch.clamp_max(idx, n - 1)[0]
        centers[i] = y[idx]
        dmin = torch.minimum(dmin, sq_dists(y, centers[i:i + 1])[:, 0])
    for _ in range(iters):
        assign = torch.argmin(sq_dists(y, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(y.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ y) / torch.clamp_min(counts[:, None], 1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    return torch.argmin(sq_dists(y, centers), dim=1)


@dataclasses.dataclass
class Landmarks:
    """What a cold solve fixes and warm solves reuse."""
    idx: torch.Tensor          # (m,) long, CPU
    gamma: float
    sketch: np.ndarray


@dataclasses.dataclass
class Solution:
    evals: np.ndarray          # (k,) smallest eigenvalues of L_norm
    embedding: np.ndarray      # (n, k) row-normalized
    assign: np.ndarray         # (n,)
    cold: bool


@dataclasses.dataclass
class EngineSpec:
    """The engine settings the reference follows."""
    seed: int
    k: int
    m: int
    eigh_cutoff: int
    drift_threshold: float


def cold_landmarks(spec: EngineSpec, table: np.ndarray, device,
                   dtype=torch.float64) -> Landmarks:
    """Landmarks uniformly without replacement from the solve's landmark
    generator, and the median-heuristic bandwidth over them."""
    n = table.shape[0]
    land_gen, _, _ = solve_generators(spec.seed, fingerprint(table))
    idx = torch.randperm(n, generator=land_gen)[:spec.m]
    x = torch.as_tensor(table).to(device=device, dtype=dtype)
    gamma = median_gamma(x, x[idx.to(device)])
    return Landmarks(idx, gamma, sketch(table, sketch_sign(spec.seed, n)))


def _blocks(n: int):
    return [(lo, min(n, lo + BLOCK_ROWS)) for lo in range(0, n, BLOCK_ROWS)]


def solve(spec: EngineSpec, table: np.ndarray, marks: Landmarks, *,
          cold: bool, device, dtype=torch.float64,
          tf32: bool = False) -> Solution:
    """One solve of ``table`` with the landmarks and bandwidth ``marks``,
    its landmark problems factored whole (the engine's path up to
    ``eigh_cutoff`` landmarks)."""
    k, m = spec.k, spec.m
    if m > spec.eigh_cutoff:
        raise NotImplementedError(
            f"m = {m} > eigh_cutoff = {spec.eigh_cutoff}: the subspace "
            f"solver's path has no reference here")
    _, _, km_gen = solve_generators(spec.seed, fingerprint(table))
    with precision(tf32), torch.no_grad():
        x = torch.as_tensor(table).to(device=device, dtype=dtype)
        n = x.shape[0]
        z = x[marks.idx.to(device)]
        g = marks.gamma
        w = torch.exp(-g * sq_dists(z, z))
        w = 0.5 * (w + w.T)
        ew, uw = top_eigh(w, m)
        w_is = isqrt(ew, uw)
        col = torch.zeros(m, dtype=dtype, device=device)
        for lo, hi in _blocks(n):
            col += torch.exp(-g * sq_dists(x[lo:hi], z)).sum(0)
        u = w_is @ (w_is @ col)
        gram = torch.zeros((m, m), dtype=dtype, device=device)
        for lo, hi in _blocks(n):
            c = torch.exp(-g * sq_dists(x[lo:hi], z))
            s = c * torch.rsqrt(torch.clamp_min(c @ u, EPS))[:, None]
            gram += s.T @ s
        mm = w_is @ gram @ w_is
        mm = 0.5 * (mm + mm.T)
        lam, basis = top_eigh(mm, k)
        proj = (w_is @ basis) * torch.rsqrt(torch.clamp_min(lam, EPS))[None]
        y = torch.empty((n, k), dtype=dtype, device=device)
        for lo, hi in _blocks(n):
            c = torch.exp(-g * sq_dists(x[lo:hi], z))
            s = c * torch.rsqrt(torch.clamp_min(c @ u, EPS))[:, None]
            v = s @ proj
            y[lo:hi] = v / torch.clamp_min(
                torch.linalg.vector_norm(v, dim=1, keepdim=True), EPS)
        assign = kmeans(km_gen, y, k)
        return Solution(evals=(1.0 - lam).cpu().numpy(),
                        embedding=y.cpu().numpy(),
                        assign=assign.cpu().numpy(), cold=cold)


class Chain:
    """One tenant's engine, followed solve by solve: the drift decision
    against the last cold solve's sketch, and the landmarks that a cold
    solve draws and warm ones reuse."""

    def __init__(self, spec: EngineSpec, n: int):
        self.spec = spec
        self.sign = sketch_sign(spec.seed, n)
        self.baseline: Optional[np.ndarray] = None
        self.marks_table: Optional[np.ndarray] = None

    def decide(self, table: np.ndarray) -> tuple:
        """(cold, drift) of a solve of ``table``; a cold one becomes the
        new baseline."""
        d = drift(sketch(table, self.sign), self.baseline)
        cold = not d <= self.spec.drift_threshold
        if cold:
            self.baseline = sketch(table, self.sign)
            self.marks_table = table
        return cold, d
