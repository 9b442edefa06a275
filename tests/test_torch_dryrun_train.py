"""The dry run's training row: the shape-only route of the calls a
differentiated step would run op by op (``roofline/counting.py::
counted_call``: ``models/attention.py::blocked_attention``,
``models/mamba.py::_ssd_chunked`` and ``models/transformer.py::
checkpoint_tp``'s layers, held on a fake mesh in
``test_torch_dryrun_train_mesh.py``) against the op-by-op count of the
same fake inputs (``counting.op_by_op``), real tensors on the plain path,
and the encoder-decoder's remat under the counter and on a real CPU run.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import attention as JA
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import mamba as MB
from repro_torch.models import transformer as T
from repro_torch.roofline.counting import StepCounter, op_by_op

DEV = "meta:0"
LIMIT_REL = 0.01          # bytes accessed and each device's peak


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module (its tensors are fake or tiny;
    under pytest-xdist a thread a core per worker oversubscribes the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel(a, b):
    return abs(a - b) / b if b else abs(a - b)


def _held(route, plain):
    """The route's counts against the op-by-op ones: FLOPs equal, bytes
    accessed and each device's peak within ``LIMIT_REL``."""
    assert route.flops == plain.flops
    for a, b in zip(route.bytes_accessed, plain.bytes_accessed):
        assert _rel(a, b) <= LIMIT_REL, (a, b)
    for a, b in zip(route.peak, plain.peak):
        assert _rel(a, b) <= LIMIT_REL, (a, b)


# -- the blocked attention's route ---------------------------------------------

# (B, Sq, T, H, K, dh, dv, causal, window, softcap, dtype, positions), q
# and kv chunks of 16 and 32: every case pads its chunks
CASES = {
    "causal-28/4": (1, 40, 40, 28, 4, 16, 16, True, None, None,
                    torch.bfloat16, False),
    "gemma-8/1-softcap": (2, 40, 40, 8, 1, 32, 32, True, None, 50.0,
                          torch.float32, False),
    "windowed-16/16": (1, 48, 48, 16, 16, 16, 16, True, 9, None,
                       torch.bfloat16, True),
    "cross-noncausal": (2, 24, 40, 4, 4, 16, 16, False, None, None,
                        torch.float32, False),
    "mla-192/128": (1, 40, 40, 2, 2, 192, 128, True, None, None,
                    torch.bfloat16, False),
}
CONTEXTS = ("plain", "checkpoint", "checkpoint_tp", "no_grad")


def _attention_step(case, context):
    """One blocked attention on fake tensors between a projection in and
    a projection out, differentiated (``context`` != no_grad): bare,
    under ``torch.utils.checkpoint`` (``transformer.maybe_checkpoint``)
    or under ``transformer.checkpoint_tp``."""
    B, Sq, Tk, H, K, dh, dv, causal, window, softcap, dtype, pos = case
    grad = context != "no_grad"

    def leaf(*shape):
        return torch.empty(*shape, dtype=dtype, device=DEV,
                           requires_grad=grad)

    q, k, v = leaf(B, Sq, H, dh), leaf(B, Tk, K, dh), leaf(B, Tk, K, dv)
    w = leaf(H * dv, 8)

    def block(q, k, v, w):
        kw = ({"q_positions": torch.arange(Sq, device=q.device),
               "k_positions": torch.arange(Tk, device=q.device)} if pos
              else {})
        out = A.blocked_attention(q * 2, k * 2, v * 2, causal=causal,
                                  window=window, softcap=softcap,
                                  q_chunk=16, kv_chunk=32, **kw)
        return out.reshape(B, Sq, H * dv) @ w

    if context == "no_grad":
        with torch.no_grad():
            block(q, k, v, w)
        return
    if context == "checkpoint":
        y = T.maybe_checkpoint(block, True)(q, k, v, w)
    elif context == "checkpoint_tp":
        # a layer over one rank: on fake tensors it replays its own count
        y = T.checkpoint_tp(lambda ps, qs, ks, vs: [block(
            qs[0], ks[0], vs[0], ps[0]["w"])], True, [{"w": w}], [q], [k],
            [v])[0]
    else:
        y = block(q, k, v, w)
    torch.autograd.grad(y.float().sum(), (q, k, v, w))


def _count(step, *args, route=True):
    counter = StepCounter([DEV])
    with FakeTensorMode(), counter, (contextlib.nullcontext() if route
                                     else op_by_op()):
        step(*args)
    return counter


@pytest.mark.parametrize("context", CONTEXTS)
@pytest.mark.parametrize("case", list(CASES))
def test_blocked_route_matches_the_op_by_op_count(case, context):
    route = _count(_attention_step, CASES[case], context)
    plain = _count(_attention_step, CASES[case], context, route=False)
    _held(route, plain)
    # forward (twice under a checkpoint) and backward replays
    phases = {"plain": {"blocked_attention": 2},
              "checkpoint": {"blocked_attention": 3},
              "checkpoint_tp": {"block": 2},
              "no_grad": {"blocked_attention": 1}}[context]
    assert route.routes == phases
    assert plain.routes == {}


def test_model_attention_takes_the_route_at_the_threshold():
    """A reduced gemma-2b loss at 2048 tokens (the blocked path's
    threshold) with remat, through ``attention``."""
    cfg = get_config("gemma-2b").reduced()
    S = A.BLOCKED_ATTN_THRESHOLD

    def step():
        params = T.init_lm(torch.Generator().manual_seed(0), cfg,
                           device=DEV)
        flat = [t.requires_grad_(True) for t in
                torch.utils._pytree.tree_leaves(params)]
        toks = torch.zeros((1, S), dtype=torch.long, device=DEV)
        loss, _ = T.lm_train_loss(params, cfg, {"tokens": toks,
                                                "labels": toks})
        torch.autograd.grad(loss, flat, allow_unused=True)

    route, plain = _count(step), _count(step, route=False)
    _held(route, plain)
    assert route.routes["blocked_attention"] == 3 * cfg.num_layers


# -- the SSD scan's route -------------------------------------------------------

def _ssd_step(S, use_final_state):
    """The Mamba-2 SSD scan of a reduced mamba2-2.7b under
    ``torch.utils.checkpoint``, its inputs views of one projection as
    ``mamba_apply`` cuts them; the final state used, or dropped as the
    training loss drops it."""
    cfg = get_config("mamba2-2.7b").reduced()
    s = cfg.ssm
    H, P, G, N = s.num_heads(cfg.d_model), s.head_dim, s.num_groups, \
        s.d_state
    width = H * P + 2 * G * N
    base = torch.empty(1, S, width, device=DEV, requires_grad=True)
    dt_raw = torch.empty(1, S, H, device=DEV, requires_grad=True)
    a_log = torch.empty(H, device=DEV, requires_grad=True)
    w = torch.empty(P, 4, device=DEV, requires_grad=True)

    def block(base, dt_raw, a_log):
        z = base * 1.0
        xh = z[..., :H * P].reshape(1, S, H, P)
        Bm = z[..., H * P:H * P + G * N].reshape(1, S, G, N)
        Cm = z[..., H * P + G * N:].reshape(1, S, G, N)
        y, h = MB._ssd_chunked(xh, torch.nn.functional.softplus(dt_raw),
                               -torch.exp(a_log), Bm, Cm, cfg, None)
        out = (y @ w).sum()
        return out + h.sum() if use_final_state else out

    loss = T.maybe_checkpoint(block, True)(base, dt_raw, a_log)
    torch.autograd.grad(loss, (base, dt_raw, a_log))


@pytest.mark.parametrize("use_final_state", [False, True])
def test_ssd_route_matches_the_op_by_op_count(use_final_state):
    route = _count(_ssd_step, 64, use_final_state)
    plain = _count(_ssd_step, 64, use_final_state, route=False)
    _held(route, plain)
    assert route.routes == {"ssd_chunked": 3}


# -- real tensors ---------------------------------------------------------------

def test_real_tensors_take_the_plain_path(monkeypatch):
    """A CPU call that requires grad runs the plain path: the route is
    never asked, and its output and gradients are bit for bit those of
    the plain body; the output matches the JAX package's blocked
    attention on the same numpy inputs."""
    def refuse(*a, **k):
        raise AssertionError("a real tensor took the shape-only route")
    monkeypatch.setattr(A, "counted_call", refuse)
    rng = np.random.default_rng(0)
    B, S, H, K, dh = 2, 40, 4, 2, 16
    q_np = rng.standard_normal((B, S, H, dh), dtype=np.float32)
    k_np = rng.standard_normal((B, S, K, dh), dtype=np.float32)
    v_np = rng.standard_normal((B, S, K, dh), dtype=np.float32)
    g_np = rng.standard_normal((B, S, H, dh), dtype=np.float32)
    kw = dict(causal=True, window=13, softcap=20.0, q_chunk=16,
              kv_chunk=32)

    def run(fn):
        q, k, v = (torch.tensor(x, requires_grad=True)
                   for x in (q_np, k_np, v_np))
        out = fn(q, k, v)
        return (out, *torch.autograd.grad(out, (q, k, v),
                                          torch.tensor(g_np)))

    got = run(lambda q, k, v: A.blocked_attention(q, k, v, **kw))
    want = run(lambda q, k, v: A._blocked_attention(
        q, k, v, q_positions=None, k_positions=None, scale=None, **kw))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = JA.blocked_attention(jnp.asarray(q_np), jnp.asarray(k_np),
                               jnp.asarray(v_np), **kw)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


# -- remat under the counter ------------------------------------------------------

@pytest.mark.parametrize("device", [DEV, "cpu"])
def test_encdec_remat_keeps_less_than_one_block_more(device):
    """The reduced encoder-decoder's loss counted with ``remat`` on and
    off, on fake tensors and on a real CPU run: with it, the peak is
    lower by at least the activations one decoder block keeps for the
    backward pass (its forward's live bytes less its output's, counted
    alone)."""
    cfg = get_config("seamless-m4t-medium").reduced()
    # activations, not the parameters, at the peak
    B, S = (8, 256) if device == DEV else (4, 128)
    fake = FakeTensorMode if device == DEV else contextlib.nullcontext

    def init():
        params = ED.init_encdec(torch.Generator().manual_seed(0), cfg,
                                device=device)
        flat = [t.requires_grad_(True) for t in
                torch.utils._pytree.tree_leaves(params)]
        return params, flat

    def peak(remat):
        counter = StepCounter([device])
        with fake(), counter:
            params, flat = init()
            toks = torch.zeros((B, S), dtype=torch.long, device=device)
            batch = {"src_embeds": torch.zeros(B, S, cfg.d_model,
                                               device=device),
                     "tokens": toks, "labels": toks}
            loss, _ = ED.encdec_train_loss(params, cfg, batch, remat=remat)
            torch.autograd.grad(loss, flat, allow_unused=True)
        return counter.peak[0]

    counter = StepCounter([device])
    with fake(), counter:
        params, _ = init()
        h = torch.zeros(B, S, cfg.d_model, device=device, requires_grad=True)
        pos = torch.arange(S, device=device)
        before = counter.live[0]
        out = ED._dec_block(params["decoder"]["blocks"][0], cfg, h, h, pos,
                            None, None, None, None)
        block = counter.live[0] - before - out.untyped_storage().nbytes()
    with_remat, without = peak(True), peak(False)
    assert block > 0
    assert without - with_remat >= block, (without, with_remat, block)
