"""The port's optimizers, schedules and clipping against the JAX package's.

The four convergence cases of ``tests/test_optim.py`` run on the port;
every update, schedule and clip runs in both packages on the same numpy
inputs and must agree to 1e-6 relative (bf16 moments: to one bf16
rounding step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as P

REL = 1e-6
BF16_REL = 2.0 ** -8


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _quad_grads(params):
    return {"x": 2 * (params["x"] - 3.0), "y": 2 * (params["y"] + 1)}


def _quad_loss(params):
    return float(torch.sum((params["x"] - 3.0) ** 2)
                 + torch.sum((params["y"] + 1) ** 2))


@pytest.mark.parametrize("make_opt", [
    lambda: P.sgd(0.1), lambda: P.sgd(0.05, momentum=0.9),
    lambda: P.adam(0.1), lambda: P.adamw(0.1, weight_decay=0.0)],
    ids=["sgd", "sgd-momentum", "adam", "adamw"])
def test_optimizers_converge_on_quadratic(make_opt):
    opt = make_opt()
    params = {"x": torch.zeros(3), "y": torch.ones(2)}
    state = opt.init(params)
    for step in range(200):
        params, state = opt.update(_quad_grads(params), state, params, step)
    assert _quad_loss(params) < 1e-2


def _tree(rng, positive=False):
    def draw(*shape):
        a = rng.normal(size=shape).astype(np.float32)
        return np.abs(a) + 0.1 if positive else a
    return {"w": draw(6, 5), "b": draw(5), "blocks": [draw(3, 4), draw(2)]}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _compare(got, want, rel=REL):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w, rel)


CASES = {
    "sgd": (lambda m: m.sgd(0.1), None),
    "sgd-momentum": (lambda m: m.sgd(0.05, momentum=0.9), ("mu",)),
    "sgd-nesterov": (lambda m: m.sgd(0.05, momentum=0.9, nesterov=True),
                     ("mu",)),
    "adam": (lambda m: m.adam(1e-2), ("m", "v")),
    "adamw": (lambda m: m.adamw(m.linear_warmup_cosine(3e-4, 4, 20)),
              ("m", "v")),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("step", [0, 7])
def test_update_matches_jax(name, step):
    make, slots = CASES[name]
    rng = np.random.default_rng(step)
    params, grads = _tree(rng), _tree(rng)
    state = {}
    for slot in slots or ():
        state[slot] = _tree(rng, positive=slot == "v")
    want_p, want_s = make(J).update(_to_jax(grads), _to_jax(state),
                                    _to_jax(params), jnp.int32(step))
    got_p, got_s = make(P).update(_to_torch(grads), _to_torch(state),
                                  _to_torch(params), step)
    _compare(got_p, want_p)
    _compare(got_s, want_s)


def test_update_writes_in_place():
    """The update donates its trees: the new values live in the storage
    of the parameters and moments passed in."""
    opt = P.adamw(1e-2)
    params = _to_torch(_tree(np.random.default_rng(0)))
    state = opt.init(params)
    before = [p.data_ptr() for p in jax.tree.leaves(params)]
    old_w = params["w"].clone()
    new_p, new_s = opt.update(_to_torch(_tree(np.random.default_rng(1))),
                              state, params, 0)
    assert [p.data_ptr() for p in jax.tree.leaves(new_p)] == before
    assert new_s is state
    assert not torch.equal(params["w"], old_w)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adam_update_in_row_slices_is_the_whole_update(state_dtype,
                                                       monkeypatch):
    """A leaf larger than ``_UPDATE_SLICE`` elements is updated slice by
    slice along its first dimension (bounding the float32 temporaries):
    the parameters and moments are those of the whole-leaf update, bit
    for bit, and stay in their storage."""
    from repro_torch.optim import optimizers as O

    rng = np.random.default_rng(4)
    shapes = {"big": (7, 3, 5), "vec": (33,), "one": (1, 40), "s": ()}

    def tree(positive=False):
        return {k: torch.tensor(np.abs(rng.normal(size=s)) if positive
                                else rng.normal(size=s), dtype=torch.float32)
                for k, s in shapes.items()}

    params, grads, m, v = tree(), tree(), tree(), tree(positive=True)
    runs = []
    for limit in (O._UPDATE_SLICE, 8):
        monkeypatch.setattr(O, "_UPDATE_SLICE", limit)
        opt = P.adamw(1e-2, state_dtype=state_dtype)
        p = {k: x.clone() for k, x in params.items()}
        st = {"m": {k: x.clone().to(getattr(torch, state_dtype))
                    for k, x in m.items()},
              "v": {k: x.clone().to(getattr(torch, state_dtype))
                    for k, x in v.items()}}
        ptrs = [x.data_ptr() for x in p.values()]
        for step in range(2):
            opt.update(grads, st, p, step)
        assert [x.data_ptr() for x in p.values()] == ptrs
        runs.append((p, st))
    assert len(O.row_slices(*[params["big"]] * 4)) == 7
    (p0, s0), (p1, s1) = runs
    for k in shapes:
        assert torch.equal(p0[k], p1[k])
        assert torch.equal(s0["m"][k], s1["m"][k])
        assert torch.equal(s0["v"][k], s1["v"][k])


def test_adam_bf16_state_dtype():
    opt = P.adam(0.1, state_dtype="bfloat16")
    params = {"x": torch.zeros(4)}
    state = opt.init(params)
    assert state["m"]["x"].dtype == torch.bfloat16
    params, state = opt.update({"x": torch.ones(4)}, state, params, 0)
    assert torch.isfinite(params["x"]).all()
    # against the JAX package's bf16 moments on random inputs
    rng = np.random.default_rng(3)
    p_np, g_np = _tree(rng), _tree(rng)
    j = J.adamw(1e-2, state_dtype="bfloat16")
    t = P.adamw(1e-2, state_dtype="bfloat16")
    jp, js = _to_jax(p_np), j.init(_to_jax(p_np))
    tp = _to_torch(p_np)
    ts = t.init(tp)
    for step in range(3):
        jp, js = j.update(_to_jax(g_np), js, jp, jnp.int32(step))
        tp, ts = t.update(_to_torch(g_np), ts, tp, step)
    assert ts["v"]["w"].dtype == torch.bfloat16
    _compare(tp, jp, BF16_REL)
    _compare(ts, jax.tree.map(lambda a: np.asarray(a, np.float32), js),
             BF16_REL)


def test_clip_by_global_norm():
    grads = {"a": torch.ones(4) * 10}
    clipped, norm = P.clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.sqrt(torch.sum(clipped["a"] ** 2))) == \
        pytest.approx(1.0, rel=1e-3)
    # below threshold: untouched
    out, _ = P.clip_by_global_norm({"a": torch.ones(4) * 0.1}, 1.0)
    np.testing.assert_allclose(out["a"].numpy(), 0.1, rtol=1e-5)
    # against JAX on a random tree, clipped and not
    g_np = _tree(np.random.default_rng(4))
    for max_norm in (0.5, 100.0):
        want, want_norm = J.clip_by_global_norm(_to_jax(g_np), max_norm)
        got, got_norm = P.clip_by_global_norm(_to_torch(g_np), max_norm)
        _close(got_norm, want_norm)
        _compare(got, want)
        _close(P.global_norm(got), J.optimizers.global_norm(want))


@pytest.mark.parametrize("sched", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_jax(sched):
    warmup, total = 10, 110
    make = {"constant": lambda m: m.constant_schedule(3e-4),
            "cosine": lambda m: m.cosine_schedule(1.0, total),
            "warmup_cosine": lambda m: m.linear_warmup_cosine(
                1.0, warmup, total)}[sched]
    jf, pf = make(J), make(P)
    for step in (0, warmup - 1, warmup, total):
        got = pf(step)
        assert got.dtype == torch.float32
        _close(got, jf(jnp.int32(step)))
    if sched == "warmup_cosine":
        assert float(pf(0)) < float(pf(warmup - 1)) <= 1.0
        assert float(pf(warmup - 1)) == pytest.approx(1.0)
    if sched == "cosine":
        assert float(pf(0)) == pytest.approx(1.0)
        assert float(pf(total)) == pytest.approx(0.1, abs=1e-3)
