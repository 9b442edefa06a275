"""The port's continuous-batching LM server against the JAX package's.

``DecodeScheduler`` in both packages gets the same weights (the JAX
``init_lm`` draw, converted) and the same requests; greedy tokens must be
identical.  The port's own batch-1 oracle and the JAX package's scheduler
unit tests (``tests/test_serve_lm.py``) are mirrored on the port's
``Server``, which draws its own weights from a torch generator.  All on
the CPU (``device="cpu"``), reduced f32 configs.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import DecodeScheduler, Request, Server
from repro_torch.models import transformer as PT

# (prompt_len, max_new_tokens) per request: tests/test_serve_lm.py's
LENGTH_PATTERNS = [
    [(5, 6), (11, 4), (2, 8), (7, 3), (16, 5)],
    [(8, 4), (8, 4), (3, 7)],
    [(1, 9), (20, 2), (13, 6)],
]


def _reqs(vocab, lens, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, p).astype(np.int32), g)
            for i, (p, g) in enumerate(lens)]


def _weights(arch):
    jcfg, pcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              pcfg)


@pytest.fixture(scope="module")
def qwen():
    return _weights("qwen2-7b")


def _serve_both(jcfg, pcfg, jp, pp, lens, *, batch=2, max_seq=48, seed=0,
                **kw):
    jax_sched = jax_serve.DecodeScheduler(jcfg, jp, batch, max_seq,
                                          **kw)
    for r in _reqs(jcfg.vocab_size, lens, seed, jax_serve.Request):
        jax_sched.submit(r)
    want = {r.uid: r.generated for r in jax_sched.drain()}
    sched = DecodeScheduler(pcfg, pp, batch, max_seq, device="cpu", **kw)
    for r in _reqs(pcfg.vocab_size, lens, seed):
        sched.submit(r)
    got = {r.uid: r.generated for r in sched.drain()}
    return got, want


@pytest.mark.parametrize("lens", LENGTH_PATTERNS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_scheduler_matches_jax(qwen, lens, use_pallas):
    with ops.use_pallas_scoped(use_pallas):
        got, want = _serve_both(*qwen, lens)
    assert got == want
    assert all(len(want[i]) == g for i, (_, g) in enumerate(lens))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gemma_prefill_and_greedy_tokens_match_jax(use_pallas):
    """Reduced gemma-2b (GeGLU, MQA, tied embeddings): the prefill logits
    and the served greedy tokens of the JAX server, on converted
    weights."""
    jcfg, pcfg, jp, pp = _weights("gemma-2b")
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    want, _ = JT.lm_prefill(jp, jcfg, {"tokens": jax.numpy.asarray(toks)},
                            JT.init_lm_cache(jcfg, 2, 16))
    with ops.use_pallas_scoped(use_pallas):
        got, _ = PT.lm_prefill(pp, pcfg,
                               {"tokens": torch.from_numpy(toks).long()},
                               PT.init_lm_cache(pcfg, 2, 16, device="cpu"))
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), err
        got_tokens, want_tokens = _serve_both(jcfg, pcfg, jp, pp,
                                              LENGTH_PATTERNS[1])
    assert got_tokens == want_tokens


@pytest.mark.parametrize("bucket", [1, 8])
def test_ssm_bucketing_matches_jax(bucket):
    """The reference pads SSM prompts into the recurrence (ROADMAP §C):
    the continuation depends on the bucket, and the port follows it."""
    jcfg, pcfg, jp, pp = _weights("mamba2-2.7b")
    with ops.use_pallas_scoped(True):
        got, want = _serve_both(jcfg, pcfg, jp, pp, [(5, 6)], batch=1,
                                max_seq=32, seed=9, prefill_bucket=bucket)
    assert got == want


def test_attention_bucketing_is_result_invariant(qwen):
    jcfg, pcfg, jp, pp = qwen
    outs = []
    for bucket in (1, 4, 16):
        sched = DecodeScheduler(pcfg, pp, 1, 32, prefill_bucket=bucket,
                                device="cpu")
        sched.submit(_reqs(pcfg.vocab_size, [(5, 6)], seed=9)[0])
        outs.append(sched.drain()[0].generated)
    assert outs[0] == outs[1] == outs[2]


def _make_server(arch="qwen2-7b", batch=2, max_seq=48, **kw):
    return Server(get_config(arch).reduced(), batch, max_seq, device="cpu",
                  **kw)


def _oracle(cfg, req, max_seq, seed=0):
    solo = Server(cfg, 1, max_seq, seed=seed, device="cpu")
    r = Request(req.uid, req.prompt, req.max_new_tokens)
    solo.serve_batch([r])
    return r.generated


@pytest.mark.parametrize("arch, lens", [
    ("qwen2-7b", LENGTH_PATTERNS[0]), ("qwen2-7b", LENGTH_PATTERNS[2]),
    ("mamba2-2.7b", [(8, 4), (16, 3), (8, 5)])])
def test_mixed_length_greedy_matches_batch1_oracle(arch, lens):
    """Every continuation from a mixed batch equals decoding it alone
    (SSM prompts at multiples of the bucket: see the bucketing test)."""
    srv = _make_server(arch)
    cfg = srv.cfg
    done = srv.serve_batch(_reqs(cfg.vocab_size, lens))
    assert len(done) == len(lens)
    for r in done:
        assert len(r.generated) == r.max_new_tokens
        assert r.generated == _oracle(cfg, r, 48)


def test_watchdog_scheduler_under_concurrent_submits(monkeypatch):
    """``DecodeScheduler``'s ``_sched_lock`` and ``_stats_lock``, and the
    ``use_pallas`` toggle's lock, under the port's watchdog while 4
    threads submit and read the stats during the decode loop of a
    reduced attn config with the kernels on: a prefill reads the toggle
    under ``_sched_lock``, so its lock must rank after the scheduler's
    (``repro_torch.analysis.watchdog``)."""
    import threading

    from repro_torch.analysis import instrument

    monkeypatch.setattr(ops, "_TOGGLE", ops._PallasToggle())
    assert instrument(ops._TOGGLE) == ["_lock"]
    srv = _make_server(batch=2, max_seq=32)
    sched = srv.scheduler
    assert sorted(instrument(sched)) == ["_sched_lock", "_stats_lock"]
    reqs = _reqs(srv.cfg.vocab_size, [(4, 3), (6, 2), (3, 4)] * 4)
    errors = []

    def submitter(part):
        try:
            for r in part:
                sched.submit(r)
                sched.stats()
        except Exception as exc:        # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=submitter, args=(reqs[i::4],))
               for i in range(4)]
    done = []
    with ops.use_pallas_scoped(True):
        for t in threads:
            t.start()
        while len(done) < len(reqs):
            if not sched.step():
                if not any(t.is_alive() for t in threads) and \
                        not sched.stats()["queue_depth"]:
                    break
            done.extend(sched.completed())
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        done.extend(sched.drain())
    assert errors == []
    assert sorted(r.uid for r in done) == sorted(r.uid for r in reqs)
    assert all(len(r.generated) == r.max_new_tokens for r in done)
    assert sched._sched_lock.acquisitions > len(reqs)
    assert ops._TOGGLE._lock.acquisitions > 0


def test_admit_retire_ordering_more_requests_than_slots():
    srv = _make_server(batch=2, max_seq=32)
    done = srv.serve_batch(_reqs(srv.cfg.vocab_size, [(4, 3)] * 7))
    assert sorted(r.uid for r in done) == list(range(7))
    s = srv.stats()
    assert (s["admitted"], s["retired"], s["occupied"], s["queue_depth"]) \
        == (7, 7, 0, 0)


def test_slot_reuse_never_leaks_prior_state():
    cfg = get_config("qwen2-7b").reduced()
    rng = np.random.default_rng(3)
    probe = Request(99, rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                    5)
    fresh = _oracle(cfg, probe, 32)
    srv = Server(cfg, 1, 32, seed=0, device="cpu")
    noise = Request(0, rng.integers(0, cfg.vocab_size, 20).astype(np.int32),
                    8)
    reused = Request(99, probe.prompt, 5)
    srv.serve_batch([noise, reused])
    assert reused.generated == fresh


def test_deterministic_under_fixed_seed_with_temperature():
    cfg = get_config("qwen2-7b").reduced()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 9, 6)]

    def run(seed):
        srv = Server(cfg, 2, 32, seed=seed, temperature=0.9, device="cpu")
        out = srv.serve_batch([Request(i, p, 6)
                               for i, p in enumerate(prompts)])
        return [r.generated for r in out]

    assert run(11) == run(11)
    assert run(11) != run(12)


def test_partial_batch_runs_no_filler_steps():
    srv = _make_server(batch=4, max_seq=24)
    srv.serve_batch(_reqs(srv.cfg.vocab_size, [(6, 5)]))
    s = srv.stats()
    assert (s["decode_tokens"], s["decode_steps"], s["tokens_generated"]) \
        == (4, 4, 5)
    expect = s["decode_tokens"] / max(s["decode_seconds"], 1e-9)
    assert srv.last_decode_tok_s == pytest.approx(expect)


def test_zero_token_requests_complete_without_slots():
    srv = _make_server(batch=2, max_seq=16)
    reqs = _reqs(srv.cfg.vocab_size, [(4, 0), (4, 3)])
    done = {r.uid: r for r in srv.serve_batch(reqs)}
    assert done[0].generated == []
    assert len(done[1].generated) == 3
    assert srv.stats()["prefills"] == 1


def test_truncation_at_cache_capacity():
    srv = _make_server(batch=1, max_seq=10)
    r = _reqs(srv.cfg.vocab_size, [(8, 50)])[0]
    srv.serve_batch([r])
    assert len(r.generated) == 3     # the prefill token + writes at 8, 9
    assert srv.stats()["truncated"] == 1


@pytest.mark.parametrize("length", [0, 9])
def test_submit_validates_prompt_length(length):
    sched = _make_server(batch=1, max_seq=8).scheduler
    with pytest.raises(ValueError):
        sched.submit(Request(0, np.zeros(length, np.int32), 3))


def test_stats_keys_mirror_the_jax_server():
    srv = _make_server(batch=2, max_seq=16)
    jax_keys = set(jax_serve.Server(jax_config("qwen2-7b").reduced(), 2,
                                    16).stats())
    s = srv.stats()
    assert jax_keys <= set(s)
    assert s["slots"] == 2 and s["occupied"] == 0


def test_server_weights_follow_the_seed_and_device():
    a = _make_server(seed=3)
    b = _make_server(seed=3)
    assert torch.equal(a.params["embed"]["w"], b.params["embed"]["w"])
    assert a.params["embed"]["w"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Server(get_config("qwen2-7b").reduced(), 1, 8)


def test_lm_cli_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
                "--batch", "2", "--requests", "3", "--prompt-len", "8",
                "--gen-len", "4", "--use-pallas"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "admitted=3" in out
    assert not ops.use_pallas()
