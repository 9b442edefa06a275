#!/usr/bin/env python3
"""Where two f32 training runs of a reduced LM part, step by step and
leaf by leaf: the card against the CPU, and the CPU against itself with
every parameter moved by one ulp.

    python3 scripts/train_divergence.py [--arch ARCH ...] [--seed S ...]
        [--steps N] [--device cpu|cuda]

Each run is ``chip_smoke.py`` phase 11c's: the reduced config in f32,
batch 2 x 16 from ``synthetic_token_batches`` (plus a VLM's prefix
embeddings or the encoder-decoder's frames), AdamW at 1e-3 through
``make_train_step`` with G = 1, kernels on; ``--seed`` moves the
parameters' and the data's seeds together (phase 11c's is 0).  Each
pair of runs is compared at every step: the loss and ``grad_norm``
(relative), the clipped gradient each leaf hands AdamW (largest
|difference| over the global norm), and after the update the leaves
whose entries moved apart most, in units of the learning rate: AdamW
moves an entry by about ``lr · m̂ / √v̂``, so an entry whose tiny
gradient took the other sign in the other run parts by up to ~2 lr.
For the leaf that parts most, the entry's gradient (over the leaf's
largest |gradient|) and its ``m̂ / √v̂`` in both runs are printed.

With ``--device cuda`` (the default when a card is visible) both pairs
run; with ``--device cpu`` only the one-ulp pair.  TF32 is turned off.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

ARCHS = ("gemma-2b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
         "deepseek-v3-671b", "internvl2-26b", "seamless-m4t-medium")


def named_leaves(tree, path=""):
    """[(path, tensor)] in the order of ``repro_torch.tree.leaves``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{path}/{i}")]
    return [] if tree is None else [(path or "/", tree)]


def run(cfg, batches, dev, lr, seed, nudge=None):
    """The steps of one run on ``dev``: a list of {loss, grad_norm,
    grads, params, ratio} per step, every tensor copied to the CPU
    (``grads`` the clipped gradients AdamW took, ``params`` the leaves
    after the update, ``ratio`` AdamW's m̂ / (√v̂ + eps))."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    base = optim.adamw(lr)
    seen = {}

    def update(grads, state, params, step):
        seen["grads"] = [g.detach().cpu().clone() for g in leaves(grads)]
        out = base.update(grads, state, params, step)
        s = float(step) + 1
        b1, b2 = 0.9, 0.95
        seen["ratio"] = [
            ((m / (1 - b1 ** s)) / (torch.sqrt(v / (1 - b2 ** s)) + 1e-8)
             ).cpu() for m, v in zip(leaves(state["m"]), leaves(state["v"]))]
        return out

    opt = optim.Optimizer(base.init, update)
    B, S = batches[0]["tokens"].shape
    step_fn = steps.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", 1), opt)
    init = ED.init_encdec if cfg.is_encoder_decoder else T.init_lm
    params = T.params_to(init(torch.Generator().manual_seed(seed), cfg,
                              device="cpu"), dev)
    if nudge is not None:
        import chip_smoke as cs
        cs.nudge_one_ulp(params, nudge)
    state = opt.init(params)
    out = []
    for i, batch in enumerate(batches):
        batch = {k: v.to(dev) for k, v in batch.items()}
        params, state, m = step_fn(params, state, i, batch)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "grads": seen["grads"], "ratio": seen["ratio"],
                    "params": [p.detach().cpu().clone()
                               for p in leaves(params)]})
    return out, [name for name, _ in named_leaves(params)]


def compare(label, a, b, names, lr, top=3):
    """Print where runs ``a`` (the reference) and ``b`` part."""
    import torch

    print(f"{label}:")
    eps = 1e-8
    for i, (x, y) in enumerate(zip(a, b)):
        dl = abs(y["loss"] - x["loss"]) / abs(x["loss"])
        dn = abs(y["grad_norm"] - x["grad_norm"]) / abs(x["grad_norm"])
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in x["grads"]))
        dg = [float((gy - gx).abs().max() / gnorm)
              for gx, gy in zip(x["grads"], y["grads"])]
        dp = [float((py - px).abs().max()) / lr
              for px, py in zip(x["params"], y["params"])]
        flips = [int(((py - px).abs() > lr).sum())
                 for px, py in zip(x["params"], y["params"])]
        worst = sorted(range(len(names)), key=lambda j: -dp[j])[:top]
        print(f"  step {i}: loss {dl:.3e}, grad_norm {dn:.3e} (relative; "
              f"before this step's update); gradient leaves differ by at "
              f"most {max(dg):.3e} of the global norm "
              f"({names[max(range(len(dg)), key=dg.__getitem__)]})")
        print("    after the update, entries apart by most (in lr; entries"
              " apart by more than lr): " + ", ".join(
                  f"{names[j]} {dp[j]:.3f} ({flips[j]} of "
                  f"{x['params'][j].numel()})" for j in worst))
        j = worst[0]
        if dp[j] > 0.5:
            k = int((y["params"][j] - x["params"][j]).abs().argmax())
            gx = x["grads"][j].flatten()
            gy = y["grads"][j].flatten()
            scale = float(gx.abs().max())
            hist = [(float(s["grads"][j].flatten()[k]),
                     float(t["grads"][j].flatten()[k]))
                    for s, t in zip(a[:i + 1], b[:i + 1])]
            print(f"    {names[j]}[{k}]: gradient {float(gx[k]) / scale:.3e}"
                  f" vs {float(gy[k]) / scale:.3e} of the leaf's largest "
                  f"|gradient|; m̂/√v̂ {float(x['ratio'][j].flatten()[k]):.4f}"
                  f" vs {float(y['ratio'][j].flatten()[k]):.4f}; its "
                  f"gradient at steps 0-{i} (AdamW's eps is {eps:.0e}): "
                  + ", ".join(f"{u:.3e} vs {v:.3e}" for u, v in hist))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", nargs="+", default=list(ARCHS))
    parser.add_argument("--seed", nargs="+", type=int, default=[0])
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None)
    args = parser.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataConfig, synthetic_token_batches
    from repro_torch.kernels import ops

    dev = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps_n = args.steps or cs.TRAIN_REDUCED_STEPS
    lr = cs.TRAIN_REDUCED_LR
    for arch in args.arch:
        cfg = get_config(arch).reduced()
        for seed in args.seed:
            rng = np.random.default_rng(seed + 12)
            batches = [cs._train_batch(
                cfg, {k: torch.from_numpy(v.astype(np.int64))
                      for k, v in b.items()}, rng, "cpu", torch.float32)
                for b in synthetic_token_batches(
                    TokenDataConfig(cfg.vocab_size, cs.TRAIN_REDUCED_S,
                                    cs.TRAIN_REDUCED_B, seed=seed),
                    steps_n)]
            with ops.use_pallas_scoped(True):
                cpu, names = run(cfg, batches, "cpu", lr, seed)
                ulp, _ = run(cfg, batches, "cpu", lr, seed, nudge=seed + 1)
                compare(f"reduced {arch} seed {seed}: CPU, every parameter "
                        f"one ulp away, against CPU", cpu, ulp, names, lr)
                if dev == "cuda":
                    card, _ = run(cfg, batches, "cuda", lr, seed)
                    compare(f"reduced {arch} seed {seed}: card against CPU",
                            cpu, card, names, lr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
