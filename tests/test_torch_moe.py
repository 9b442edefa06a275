"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's.

The six cases of ``tests/test_moe.py`` run on both packages with the JAX
``moe_init`` draw converted to torch; outputs and metrics are held to
1e-5 of the largest entry (f32, the CPU).  The dispatch itself (the
stable sort by expert and the kept rows) is held exactly at a lossless,
a dropping and a chunked token count.  Then the three MoE archs, reduced,
through the port's ``DecodeScheduler`` on converted weights: the JAX
server's greedy tokens, with ``use_pallas`` off and on, and the port's
``Server`` batch-served tokens equal to its batch-1 oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.launch import serve as jax_serve
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import DecodeScheduler, Request, Server
from repro_torch.models import moe as PMOE
from repro_torch.models import transformer as PT

KEY = jax.random.PRNGKey(0)
REL = 1e-5
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
             "jamba-v0.1-52b")


def mk_cfgs(**kw):
    """(JAX config, port config) of tests/test_moe.py's tiny MoE."""
    base = dict(name="t", arch_type="moe", num_layers=1, d_model=16,
                num_heads=2, num_kv_heads=2, head_dim=8, d_ff=32,
                vocab_size=64, num_experts=4, experts_per_token=2,
                moe_d_ff=32, param_dtype="float32", compute_dtype="float32")
    base.update(kw)
    return JaxModelConfig(**base), ModelConfig(**base)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def init_both(jcfg, key=KEY):
    jp = JMOE.moe_init(key, jcfg)
    return jp, to_torch(jp)


def x_of(shape):
    """tests/test_moe.py's input: ``jax.random.normal(KEY, shape)``."""
    return np.asarray(jax.random.normal(KEY, shape))


def apply_both(jp, pp, jcfg, pcfg, x):
    want, wm = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    got, gm = PMOE.moe_apply(pp, torch.from_numpy(x), pcfg)
    return (got.numpy(), {k: float(v) for k, v in gm.items()},
            np.asarray(want), {k: float(v) for k, v in wm.items()})


def close(got, want, rel=REL):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def close_metrics(gm, wm):
    assert gm.keys() == wm.keys()
    for k in wm:
        assert gm[k] == pytest.approx(wm[k], rel=REL, abs=1e-7), k


def test_moe_shapes_and_finite():
    jcfg, pcfg = mk_cfgs()
    jp, pp = init_both(jcfg)
    got, gm, want, wm = apply_both(jp, pp, jcfg, pcfg, x_of((2, 8, 16)))
    assert got.shape == (2, 8, 16) and np.isfinite(got).all()
    assert gm["moe_aux_loss"] > 0
    close(got, want)
    close_metrics(gm, wm)


def test_small_batch_is_lossless():
    jcfg, pcfg = mk_cfgs()
    jp, pp = init_both(jcfg)
    got, gm, want, wm = apply_both(jp, pp, jcfg, pcfg, x_of((4, 16, 16)))
    assert gm["moe_dropped_frac"] == wm["moe_dropped_frac"] == 0.0
    close(got, want)


def test_top1_matches_manual_dense_computation():
    """Top-1 with no drops: each token through its argmax expert at gate
    1.0, computed by hand, and the JAX package's output."""
    jcfg, pcfg = mk_cfgs(experts_per_token=1, num_shared_experts=0)
    jp, pp = init_both(jcfg)
    x = x_of((1, 8, 16))
    got, _, want, _ = apply_both(jp, pp, jcfg, pcfg, x)
    xf = torch.from_numpy(x.reshape(-1, 16))
    assign = torch.argmax(xf @ pp["router"]["w"], dim=-1)
    we = pp["experts"]
    ref = torch.stack([
        (torch.nn.functional.silu(xf[t] @ we["gate"][e])
         * (xf[t] @ we["up"][e])) @ we["down"][e]
        for t, e in enumerate(assign.tolist())])
    np.testing.assert_allclose(got.reshape(-1, 16), ref.numpy(), atol=1e-4)
    close(got, want)


def test_shared_expert_added():
    jcfg, pcfg = mk_cfgs(num_shared_experts=1)
    jp, pp = init_both(jcfg)
    x = x_of((1, 8, 16))
    with_shared, _, want, _ = apply_both(jp, pp, jcfg, pcfg, x)
    jcfg0, pcfg0 = mk_cfgs(num_shared_experts=0)
    pp0 = {k: v for k, v in pp.items() if k != "shared"}
    without, _ = PMOE.moe_apply(pp0, torch.from_numpy(x), pcfg0)
    shared = JL.mlp(jp["shared"], jnp.asarray(x.reshape(-1, 16)),
                    act=jcfg.mlp_act)
    np.testing.assert_allclose(
        with_shared, without.numpy() + np.asarray(shared).reshape(1, 8, 16),
        atol=1e-5)
    close(with_shared, want)


def _skewed(jp, pp, expert):
    w = np.zeros((16, 4), np.float32)
    w[:, expert] = 10.0
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    pp = {**pp, "router": {"w": torch.from_numpy(w)}}
    return jp, pp


def test_capacity_drops_when_forced():
    """4096 tokens x k=2 routed to one expert at capacity 2048: a quarter
    of the assignments drop, in both packages."""
    jcfg, pcfg = mk_cfgs(capacity_factor=1.0)
    jp, pp = _skewed(*init_both(jcfg), 0)
    got, gm, want, wm = apply_both(jp, pp, jcfg, pcfg, x_of((8, 512, 16)))
    assert gm["moe_dropped_frac"] == pytest.approx(0.25, abs=0.03)
    assert gm["moe_dropped_frac"] == wm["moe_dropped_frac"]
    close(got, want)


def test_aux_loss_prefers_balance():
    jcfg, pcfg = mk_cfgs()
    jp, pp = init_both(jcfg)
    x = x_of((2, 32, 16))
    _, balanced, _, want_balanced = apply_both(jp, pp, jcfg, pcfg, x)
    _, skewed, _, want_skewed = apply_both(*_skewed(jp, pp, 1), jcfg, pcfg,
                                           x)
    assert skewed["moe_aux_loss"] > balanced["moe_aux_loss"]
    close_metrics(balanced, want_balanced)
    close_metrics(skewed, want_skewed)


def jax_dispatch(jp, xf, jcfg):
    """(order, keep) of the JAX package's ``_moe_shard``, step for step."""
    T = xf.shape[0]
    E, k = jcfg.num_experts, jcfg.experts_per_token
    probs = jax.nn.softmax(xf @ jp["router"]["w"], axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    counts = jnp.zeros((E,), jnp.float32).at[top_i.reshape(-1)].add(1.0)
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e)
    starts = jnp.cumsum(counts.astype(jnp.int32)) - counts.astype(jnp.int32)
    pos = jnp.arange(T * k, dtype=jnp.int32) - starts[flat_e[order]]
    return np.asarray(order), np.asarray(pos < JMOE._capacity(T, jcfg))


@pytest.mark.parametrize("shape, drops", [
    ((2, 64), False),           # T·k = 256: lossless
    ((1, 4096), True),          # T·k = 8192 > 4096: C = 2048 of 8192 rows
    ((2, 8192), True),          # T = 16384: two dispatch chunks of 8192
])
def test_dispatch_and_output_match_jax(shape, drops):
    """Output, metrics and the kept rows, at capacity factor 1.0 with one
    expert favoured so that the large calls drop rows."""
    jcfg, pcfg = mk_cfgs(capacity_factor=1.0)
    jp, pp = init_both(jcfg)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 0] += 0.5
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    pp = {**pp, "router": {"w": torch.from_numpy(w)}}
    x = np.random.default_rng(1).normal(size=(*shape, 16)).astype(
        np.float32)
    got, gm, want, wm = apply_both(jp, pp, jcfg, pcfg, x)
    close(got, want)
    close_metrics(gm, wm)
    assert (gm["moe_dropped_frac"] > 0) == drops
    xf = x.reshape(-1, 16)
    chunks = (np.split(xf, len(xf) // PMOE._DISPATCH_CHUNK)
              if len(xf) > PMOE._DISPATCH_CHUNK else [xf])
    for xc in chunks:
        r = PMOE.route(pp, torch.from_numpy(xc), pcfg)
        order, keep = jax_dispatch(jp, jnp.asarray(xc), jcfg)
        np.testing.assert_array_equal(r["order"].numpy(), order)
        np.testing.assert_array_equal(r["keep"].numpy(), keep)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    want_p, want_i = jax.lax.top_k(jnp.asarray(probs), 2)
    got_p, got_i = PMOE._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("tokens", [1, 682, 683, 4096])
def test_capacity_matches_jax(tokens):
    """Lossless up to T·k = 4096 (k = 6: prompts of up to 682 tokens)."""
    jcfg = jax_config("moonshot-v1-16b-a3b")
    pcfg = get_config("moonshot-v1-16b-a3b")
    assert PMOE._capacity(tokens, pcfg) == JMOE._capacity(tokens, jcfg)


# -- the MoE archs, reduced, through the server -------------------------------

def _weights(arch):
    jcfg, pcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              pcfg)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    return _weights(request.param)


def _reqs(vocab, lens, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, p).astype(np.int32), g)
            for i, (p, g) in enumerate(lens)]


# prompts at multiples of the bucket (jamba's Mamba layer runs the pad)
LENS = [(8, 4), (16, 3), (8, 5)]


def test_moe_layers_are_where_jax_puts_them(moe_model):
    jcfg, pcfg, _, pp = moe_model
    types = PT.layer_types(pcfg)
    assert types == JT.layer_types(jcfg)
    assert any(ffn == "moe" for _, ffn in types)
    mine = PT.init_lm(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert (jax.tree.map(lambda t: tuple(t.shape), mine)
            == jax.tree.map(lambda t: tuple(t.shape), pp))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_moe_archs_serve_jax_tokens(moe_model, use_pallas):
    jcfg, pcfg, jp, pp = moe_model
    jax_sched = jax_serve.DecodeScheduler(jcfg, jp, 2, 32)
    for r in _reqs(jcfg.vocab_size, LENS, cls=jax_serve.Request):
        jax_sched.submit(r)
    want = {r.uid: r.generated for r in jax_sched.drain()}
    with ops.use_pallas_scoped(use_pallas):
        sched = DecodeScheduler(pcfg, pp, 2, 32, device="cpu")
        for r in _reqs(pcfg.vocab_size, LENS):
            sched.submit(r)
        got = {r.uid: r.generated for r in sched.drain()}
    assert got == want
    assert all(len(want[i]) == g for i, (_, g) in enumerate(LENS))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_batch_matches_batch1_oracle(arch):
    cfg = get_config(arch).reduced()
    srv = Server(cfg, 2, 32, device="cpu")
    done = srv.serve_batch(_reqs(cfg.vocab_size, LENS))
    for r in done:
        solo = Server(cfg, 1, 32, device="cpu")
        again = Request(r.uid, r.prompt, r.max_new_tokens)
        solo.serve_batch([again])
        assert len(r.generated) == r.max_new_tokens
        assert r.generated == again.generated


def test_moonshot_full_config_has_the_published_size():
    """28.39e9 parameters: 56.8 GB in bf16, one H100 80GB holds it."""
    cfg = get_config("moonshot-v1-16b-a3b")
    assert round(cfg.param_count() / 1e9, 2) == 28.39
    assert sum(ffn == "moe" for _, ffn in PT.layer_types(cfg)) == 47
    assert cfg.param_dtype == "bfloat16"
