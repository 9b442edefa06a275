"""The batch-1 ``long_500k`` layout served over a (2, 2) mesh: a batch
that the data axes do not divide is run whole by every replica, and a KV
or latent cache's sequence is cut over ``(data, model)`` (four slices in
device order), or over ``data`` alone where only ``data`` divides it;
a decode step's partial softmaxes are combined over the whole mesh.

Reduced f32 qwen2-7b (windowed decode), jamba-v0.1 (Mamba-2, attention
and MoE layers; no window: a hybrid) and deepseek-v3 (MLA, windowed) at
a ``long_500k``-named shape of 64 rows (the (data, model) cut) and 66
rows (the ``data`` fallback), ``long_context_window = 8``, against the
JAX package's jitted one-device steps on the same weights: a prompt of
20 tokens, then greedy decode steps at positions 33-36 (the window
(25, 33] spans devices 1 and 2 at 64 rows, the two data slices at 66)
and 61-63 (the window lies in the last slice: the other devices see no
key and weigh exactly 0).  Held: the logits within ``LOGIT_REL`` of
their largest entry, the same greedy tokens, every cache shard the
block of the JAX cache its spec names, and after every step the
replicas' copies of each leaf held whole over data (an SSM state, a
conv tail) equal bit for bit.  qwen2-7b also on the multi-pod mesh (2,
2, 2): its sequence over (pod, data, model), or over data alone.
"""

import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.tree import leaves
from test_torch_serve_mesh_mla import (assert_serves_like_jax, cfgs,
                                       jax_serve, prompt)
from test_torch_train_mesh import one_thread  # noqa: F401

SHAPE, WINDOW, PROMPT = "long_500k", 8, 20
POSITIONS = [33, 34, 35, 36, 61, 62, 63]
ARCHS = ("qwen2-7b", "jamba-v0.1-52b", "deepseek-v3-671b")
# cache rows -> the cut of a KV or latent cache's sequence at (2, 2)
ROWS = {64: ("data", "model"), 66: "data"}


_RUNS = {}


def _jax_run(arch, rows):
    if (arch, rows) not in _RUNS:
        jcfg, _ = cfgs(arch, long_context_window=WINDOW)
        _RUNS[arch, rows] = jax_serve(jcfg, prompt(jcfg, 1, PROMPT), rows,
                                      POSITIONS, SHAPE)
    return _RUNS[arch, rows]


def _replicas_equal(caches, mesh):
    """Each leaf held whole over data has equal copies on every replica."""
    M = mesh.ranks
    for x in leaves(caches):
        if x.parts == 1:
            for d in range(M, mesh.size):
                assert torch.equal(x.shards[d], x.shards[d % M])


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch1_long_context_over_data_and_model(arch, rows):
    _, cfg = cfgs(arch, long_context_window=WINDOW)
    mesh = make_test_mesh(2, 2, device="cpu")
    specs = PS.cache_pspecs(PS.cache_specs(cfg, 1, rows), mesh, 1)
    seq = [layer.get("k", layer.get("ckv")) for layer in specs]
    assert {s[1] for s in seq if s is not None} == {ROWS[rows]}
    window = PS.decode_window(cfg, ShapeConfig(SHAPE, rows, 1, "decode"))
    assert window == (None if cfg.arch_type == "hybrid" else WINDOW)
    assert_serves_like_jax(cfg, _jax_run(arch, rows), mesh,
                           prompt(cfg, 1, PROMPT), rows, POSITIONS, SHAPE,
                           check=lambda caches, i: _replicas_equal(caches,
                                                                   mesh))


@pytest.mark.parametrize("rows, cut", [(64, ("pod", "data", "model")),
                                       (66, "data")])
def test_batch1_long_context_over_pod_data_and_model(rows, cut):
    """The multi-pod mesh (2, 2, 2): 64 rows cut over (pod, data, model)
    into eight slices of 8 (the window of 8 spans two or three), 66 over
    ``data`` alone (whole over pod and model: the two pods' replicas
    hold the same slices)."""
    _, cfg = cfgs("qwen2-7b", long_context_window=WINDOW)
    mesh = make_test_mesh(2, 2, pod=2, device="cpu")
    spec = PS.cache_pspecs(PS.cache_specs(cfg, 1, rows), mesh, 1)[0]["k"]
    assert spec[1] == cut
    assert_serves_like_jax(cfg, _jax_run("qwen2-7b", rows), mesh,
                           prompt(cfg, 1, PROMPT), rows, POSITIONS, SHAPE)
