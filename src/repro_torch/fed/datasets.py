"""Synthetic stand-ins for MNIST / Fashion-MNIST / CIFAR-10.

A copy of the JAX package's ``fed/datasets.py`` (pure numpy), so the port
makes the same data, bit for bit, from the same seed.

Nothing is downloaded, so the paper's three datasets are replaced by
procedurally generated look-alikes with the same shapes
and cardinalities.  Each class is a smoothed random prototype image plus
per-sample noise and a random affine jitter; the class-separation scale is
tuned per dataset so the relative difficulty ordering matches the paper
(MNIST easiest, CIFAR-10 hardest).  All claims validated on these data are
*relative* (selection policy A vs B) — absolute accuracies are not
comparable to the paper's.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    image_size: int
    channels: int
    num_classes: int
    train_size: int
    test_size: int
    separation: float      # prototype scale vs unit noise — task difficulty


DATASETS = {
    "mnist": DatasetSpec("mnist", 28, 1, 10, 60_000, 10_000, 2.5),
    "fashion_mnist": DatasetSpec("fashion_mnist", 28, 1, 10, 60_000, 10_000, 1.6),
    "cifar10": DatasetSpec("cifar10", 32, 3, 10, 50_000, 10_000, 0.9),
}


def _smooth(img: np.ndarray, passes: int = 2) -> np.ndarray:
    """Cheap box blur so prototypes have spatial structure like digits."""
    for _ in range(passes):
        img = (img
               + np.roll(img, 1, axis=0) + np.roll(img, -1, axis=0)
               + np.roll(img, 1, axis=1) + np.roll(img, -1, axis=1)) / 5.0
    return img


def make_dataset(name: str, *, seed: int = 0, train_size: int | None = None,
                 test_size: int | None = None):
    """Returns dict with x_train (N,H,W,C) float32, y_train (N,) int32,
    x_test, y_test."""
    spec = DATASETS[name]
    # crc32, not hash(): str hashes are randomized per process, and the
    # prototypes must replay bit-identically across processes (the
    # realism CI gate re-runs the exact grid recorded in BENCH_fed.json)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2 ** 16))
    n_tr = train_size or spec.train_size
    n_te = test_size or spec.test_size
    H = spec.image_size

    protos = rng.normal(size=(spec.num_classes, H, H, spec.channels))
    protos = np.stack([_smooth(p) for p in protos]) * spec.separation

    def gen(n, seed_off):
        r = np.random.default_rng(seed + seed_off)
        y = r.integers(0, spec.num_classes, size=n).astype(np.int32)
        x = protos[y].astype(np.float32)
        # random per-sample translation jitter (±2 px) + pixel noise
        shifts = r.integers(-2, 3, size=(n, 2))
        for axis in (1, 2):
            # vectorized roll by unique shift values
            for s in range(-2, 3):
                m = shifts[:, axis - 1] == s
                if s and m.any():
                    x[m] = np.roll(x[m], s, axis=axis)
        x = x + r.normal(size=x.shape).astype(np.float32)
        return x, y

    x_tr, y_tr = gen(n_tr, 1)
    x_te, y_te = gen(n_te, 2)
    return {"x_train": x_tr, "y_train": y_tr, "x_test": x_te, "y_test": y_te,
            "spec": spec}
