"""The port's token pipeline against the JAX package's: the same batches
bit for bit, determinism, and the prefetch iterator."""

import numpy as np
import pytest
import torch

from repro.data import TokenDataConfig as JaxTokenDataConfig
from repro.data import synthetic_token_batches as jax_batches
from repro_torch.data import (TokenDataConfig, make_batch_iterator,
                              synthetic_token_batches)


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (100, 16, 4, 1), (256000, 33, 3, 7), (50, 8, 2, 0)])
def test_batches_equal_jax(vocab, seq, batch, seed):
    got = list(synthetic_token_batches(
        TokenDataConfig(vocab, seq, batch, seed=seed), 3))
    want = list(jax_batches(JaxTokenDataConfig(vocab, seq, batch, seed=seed),
                            3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])


def test_stream_determinism():
    cfg = TokenDataConfig(vocab_size=50, seq_len=8, global_batch=2, seed=7)
    a = [b["tokens"] for b in synthetic_token_batches(cfg, 3)]
    b = [b["tokens"] for b in synthetic_token_batches(cfg, 3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_iterator_prefetch_completes():
    cfg = TokenDataConfig(vocab_size=32, seq_len=8, global_batch=2, seed=0)
    batches = list(make_batch_iterator(cfg, device="cpu", num_batches=3))
    assert len(batches) == 3
    want = list(synthetic_token_batches(cfg, 3))
    for got, w in zip(batches, want):
        for k in ("tokens", "labels"):
            t = got[k]
            assert t.dtype == torch.int64 and t.device.type == "cpu"
            assert tuple(t.shape) == (2, 8)
            np.testing.assert_array_equal(t.numpy(), w[k])


def test_iterator_defaults_to_the_card():
    cfg = TokenDataConfig(vocab_size=32, seq_len=8, global_batch=2)
    if torch.cuda.is_available():
        batch = next(make_batch_iterator(cfg, num_batches=1))
        assert batch["tokens"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(make_batch_iterator(cfg, num_batches=1))
