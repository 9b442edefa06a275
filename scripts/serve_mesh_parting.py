#!/usr/bin/env python3
"""Where a sharded serving prefill parts from one device: the MoE routes.

    python3 scripts/serve_mesh_parting.py [--arch ARCH] [--mesh DATA MODEL]
        [--layers N] [--seed-offset K] [--cards]

The case is ``chip_smoke.py`` phase 15b's f32 depth cut: ``--arch`` at
full width cut to ``--layers`` layers in f32, ``init_lm``'s weights from
``LM_SEED + --seed-offset`` drawn part by part onto the mesh, its 4 rows
of 2048 tokens.  The one-device prefill runs on the whole model on
cuda:0, the ``build_step`` prefill on a (data, model) mesh: the visible
cards with ``--cards``, else ``(cuda:0,) * D`` (the same arithmetic on
one card).  Printed: the prefill logits' parting over the largest
|logit|, and for each MoE layer the tokens that the two runs send to a
different set of experts, with the smallest top-k margin (the k-th
router probability less the next one) of the one-device run, overall
and among those tokens.  Then the same for the whole model again with
every parameter one ulp away (``torch.nextafter``, a seeded coin a
parameter): the model's own sensitivity at this draw.  TF32 is off.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--seed-offset", type=int, default=2)
    ap.add_argument("--cards", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]

    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.sharding import gather_params
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    print(cs.card_line())
    data, model = args.mesh
    n = data * model
    mesh = (make_test_mesh(data, model, device="cuda:0") if args.cards
            else make_test_mesh(data, model, devices=("cuda:0",) * n))
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers,
                              param_dtype="float32", compute_dtype="float32")
    k = cfg.experts_per_token
    B, P, S = cs.SERVE_4_ROWS, cs.SERVE_4_PROMPT, cs.SERVE_4_CACHE
    shape = ShapeConfig("serve", S, B, "prefill")
    batch = cs._serve_prompt(cfg, B, P)

    calls = []
    router = MOE._router

    def recording(p, xf, k_):
        out = router(p, xf, k_)
        top = torch.sort(out[1], dim=-1, descending=True).values
        calls.append((torch.sort(out[3], dim=-1).values,
                      top[:, k_ - 1] - top[:, k_]))
        return out

    MOE._router = recording

    def prefill(fn, params):
        calls.clear()
        with torch.no_grad(), ops.use_pallas_scoped(True):
            logits, caches = fn(params, batch)
        del caches
        return logits, list(calls)

    sharded = cs._init_on_mesh(cfg, mesh, cs.LM_SEED + args.seed_offset)
    whole = gather_params(sharded, "cuda:0")
    one = steps.make_prefill_step(cfg, shape)
    want, want_calls = prefill(one, whole)
    with torch.no_grad():
        g = torch.Generator(device="cuda:0").manual_seed(cs.LM_SEED)
        for p in leaves(whole):
            up = torch.rand(p.shape, generator=g, device=p.device) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf,
                                                   -torch.inf)))
            del up
    ulp, ulp_calls = prefill(one, whole)
    del whole
    got, mesh_calls = prefill(steps.build_step(cfg, shape, mesh).fn, sharded)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    # one router call a layer on one device, one a device on the mesh
    assert len(want_calls) == len(ulp_calls) == n_moe, len(want_calls)
    assert len(mesh_calls) == n * n_moe, len(mesh_calls)
    # the mesh routes each device's copy of its replica's rows: the
    # first rank of each replica, in replica order, is the whole batch
    M, D = model, n
    mesh_routes = []
    for layer in range(n_moe):
        per_dev = mesh_calls[layer * D:(layer + 1) * D]
        mesh_routes.append(tuple(torch.cat([per_dev[r * M][i].to("cuda:0")
                                            for r in range(data)])
                                 for i in range(2)))

    def report(name, logits, routes):
        err = float((logits - want).abs().max() / want.abs().max())
        parts = []
        for layer, ((ti, _), (wi, wm)) in enumerate(zip(routes, want_calls)):
            moved = (ti != wi).any(-1)
            parts.append(
                f"MoE layer {layer}: {int(moved.sum())} of {len(moved)} "
                f"tokens routed apart, smallest margin {float(wm.min()):.3e}"
                + (f" ({float(wm[moved].min()):.3e} among them)"
                   if bool(moved.any()) else ""))
        print(f"{name}: prefill logits {err:.3e} of the largest; "
              + "; ".join(parts))

    print(f"{args.arch} cut to {cfg.num_layers} layers in f32 "
          f"({cfg.param_count() / 1e9:.3f}e9 parameters), seed LM_SEED + "
          f"{args.seed_offset}, {B} rows of {P} tokens, top-{k} of "
          f"{cfg.num_experts} experts, {n_moe} MoE layers")
    report(f"mesh {mesh.sizes} on {[str(d) for d in mesh.devices]}", got,
           mesh_routes)
    report("whole model one ulp away", ulp, ulp_calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
