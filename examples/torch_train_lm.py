"""Train an LM of the PyTorch/CUDA port on the synthetic token stream
(end-to-end driver).

Default is a reduced model; ``--preset 100m`` trains a ~100M-param
gemma-style model (8 layers, d_model 768, GeGLU, 32k vocab, f32) for a
few hundred steps.  The port's twin of ``examples/train_lm.py``: the
same presets, flags and report, plus the median step time, tokens a
second and (on the card) the peak device memory.  It runs on the card
unless ``--device cpu`` is given.  Training launches no hand-written
kernel: a differentiated call takes the plain attention.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 100
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
"""

import argparse
import dataclasses
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def preset_config(preset: str):
    """The ``tiny`` (reduced gemma-2b, vocab 2048) or ``100m`` config."""
    from repro_torch.configs import get_config

    base = get_config("gemma-2b")
    if preset == "tiny":
        return dataclasses.replace(base.reduced(), vocab_size=2048)
    # ~100M params: 8 layers, d_model 768, GeGLU, 32k vocab
    return dataclasses.replace(
        base, num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=3072, vocab_size=32768,
        param_dtype="float32", compute_dtype="float32")


def main(argv=None):
    """Returns {"cfg", "params" (the trained tree), "num_params",
    "losses" (one a step), "step_seconds" (one a step, each ending in the
    loss's read-back), "tok_s" (over the median step), "peak_bytes" (the
    card's ``max_memory_allocated``; None on the CPU)}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenDataConfig, make_batch_iterator
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    dev = resolve_device(args.device)
    cfg = preset_config(args.preset)
    shape = ShapeConfig("train", args.seq_len, args.global_batch, "train")
    opt = make_optimizer(cfg, args.steps, state_dtype="float32")
    step_fn = make_train_step(cfg, shape, opt)

    params = T.init_lm(torch.Generator(device=dev).manual_seed(args.seed),
                       cfg, device=dev)
    if dev.type == "cuda":
        # after the first allocation: a card's allocator refuses a reset
        # before it; the parameters stay, so the peak counts them
        torch.cuda.reset_peak_memory_stats(dev)
    n = sum(x.numel() for x in leaves(params))
    print(f"model: {n/1e6:.1f}M params "
          f"({cfg.num_layers}L d={cfg.d_model} V={cfg.vocab_size}) on {dev}")
    opt_state = opt.init(params)
    data = TokenDataConfig(cfg.vocab_size, args.seq_len, args.global_batch,
                           seed=args.seed)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    losses, step_seconds = [], []
    tokens = args.global_batch * args.seq_len
    t0 = time.time()
    for step, batch in enumerate(make_batch_iterator(
            data, device=dev, num_batches=args.steps)):
        ts = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, step, batch)
        # the step's end: its loss comes back to the host
        losses.append(float(m["loss"]))
        step_seconds.append(time.perf_counter() - ts)
        if step % args.log_every == 0 or step == args.steps - 1:
            toks = tokens * (step + 1)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"{toks/(time.time()-t0):,.0f} tok/s")
        if ckpt and step and step % 100 == 0:
            ckpt.save(step, {"params": params})
    print(f"done: final loss {losses[-1]:.4f} "
          f"in {time.time()-t0:.0f}s")
    step_ms = statistics.median(step_seconds) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    print(f"median step {step_ms:.3f} ms, {tokens / step_ms * 1e3:,.0f} "
          f"tok/s; peak device memory "
          + (f"{peak / 2**30:.3f} GiB" if peak is not None
             else "not measured (CPU)"))
    return {"cfg": cfg, "params": params, "num_params": n, "losses": losses,
            "step_seconds": step_seconds,
            "tok_s": tokens / step_ms * 1e3, "peak_bytes": peak}


if __name__ == "__main__":
    main()
