"""Token pipeline for LM training.

Port of the JAX package's ``data/pipeline.py``.  Token streams are
generated procedurally (a mixture of n-gram-ish Markov chains, so the LM
has learnable structure, unlike uniform noise): no download.
:func:`synthetic_token_batches` is a copy of the reference's numpy
generator, so a config gives the same batches bit for bit.
``make_batch_iterator`` yields them on a device as int64 tensors
(torch's ``gather`` and indexing take int64), with host prefetch on a
producer thread.  With a mesh it yields each batch as row shards, one
per device, as the JAX package shards a batch over the data axes
(``models/sharding.py::batch_rows``).
"""

from __future__ import annotations

import dataclasses
import threading
from queue import Queue
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.sharding import batch_rows


@dataclasses.dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # Markov order of the synthetic stream


def _markov_tables(cfg: TokenDataConfig):
    rng = np.random.default_rng(cfg.seed)
    # sparse-ish transition structure: each context prefers ~8 successors
    k = min(cfg.vocab_size, 8)
    ctx = min(cfg.vocab_size, 512)
    succ = rng.integers(0, cfg.vocab_size, size=(ctx, k))
    return ctx, succ


def synthetic_token_batches(cfg: TokenDataConfig,
                            num_batches: Optional[int] = None):
    """Yields {tokens, labels} numpy int32 batches (B, seq_len)."""
    ctx_n, succ = _markov_tables(cfg)
    rng = np.random.default_rng(cfg.seed + 1)
    i = 0
    while num_batches is None or i < num_batches:
        # vectorized Markov rollout
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, cfg.global_batch)
        for t in range(cfg.seq_len):
            ctx = toks[:, t] % ctx_n
            choice = rng.integers(0, succ.shape[1], cfg.global_batch)
            nxt = succ[ctx, choice]
            noise = rng.random(cfg.global_batch) < 0.1
            nxt = np.where(noise,
                           rng.integers(0, cfg.vocab_size, cfg.global_batch),
                           nxt)
            toks[:, t + 1] = nxt
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        i += 1


def make_batch_iterator(cfg: TokenDataConfig, device=None,
                        num_batches: Optional[int] = None,
                        prefetch: int = 2, *, mesh=None,
                        microbatches: int = 1) -> Iterator:
    """Host-prefetched iterator of batches on ``device`` (None: the card).

    A producer thread generates up to ``prefetch`` batches ahead and
    turns them into int64 tensors, in pinned memory when the device is a
    card, so the copy to the card is asynchronous (``non_blocking``).

    With ``mesh`` (a ``launch/mesh.py::NamedMesh``; no ``device``), each
    batch is a list of one dict per device of the mesh: device d holds
    the rows of its replica (data coordinate) ``d // ranks`` under
    ``microbatches`` G (``sharding.batch_rows``, the order
    ``launch/steps.py::make_train_step(mesh=)`` takes), cut and pinned
    once a replica on the producer thread and copied to each of its
    ``model`` ranks' devices.
    """
    if mesh is not None and device is not None:
        raise ValueError("pass device or mesh, not both")
    devices = (resolve_device(device),) if mesh is None else mesh.devices
    R, M = (1, 1) if mesh is None else (len(mesh.replicas), mesh.ranks)
    pin = devices[0].type == "cuda"
    gen = synthetic_token_batches(cfg, num_batches)

    q: Queue = Queue(maxsize=prefetch)
    _DONE = object()

    def host(a):
        t = torch.from_numpy(a.astype(np.int64))
        return t.pin_memory() if pin else t

    def rows(batch, r):
        return {k: host(batch_rows(v, R, microbatches, r))
                for k, v in batch.items()}

    def producer():
        try:
            for batch in gen:
                q.put({k: host(v) for k, v in batch.items()} if mesh is None
                      else [rows(batch, r) for r in range(R)])
        except Exception as err:     # handed to the consumer, which raises
            q.put(err)
            return
        q.put(_DONE)

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    def to(shard, dev):
        return {k: v.to(dev, non_blocking=True) for k, v in shard.items()}

    while True:
        batch = q.get()
        if batch is _DONE:
            return
        if isinstance(batch, Exception):
            raise batch
        yield (to(batch, devices[0]) if mesh is None
               else [to(batch[d // M], dev) for d, dev in enumerate(devices)])
