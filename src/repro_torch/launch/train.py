"""Training launcher of the port: LM training or federated (FL) training.

Standard mode trains an LM of the zoo over the synthetic token pipeline,
with checkpointing, data-parallel over every visible card: as the JAX
launcher does, it builds ``make_test_mesh(data=n, model=1)`` over the n
cards (``--device`` first), shards parameters, AdamW moments and the
gradient accumulator by ``models/sharding.py``'s rules, and splits each
batch (with the encoder-decoder's zero frames) over the cards
(``launch/steps.py::make_train_step(mesh=)``).  ``--device cpu`` trains
on one CPU.  An MoE family trains over the cards too: each MoE layer
routes the whole microbatch's tokens across them and sends each row to
the card that holds its expert (expert parallelism).  ``--fl`` runs
the paper's federated workflow: DQRE-SCnet (or a baseline policy)
selects the cohort every communication round.  The flags are the JAX
package's ``repro.launch.train`` flags plus ``--device`` (``"cuda"``
unless given; ``--device cpu`` runs the plain PyTorch path on the CPU).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --device cpu --steps 20 --global-batch 8 --seq-len 128
  # qwen2-7b at full width over four cards
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --steps 20 --global-batch 8 --seq-len 256 --microbatches 2
  # reduced moonshot-v1-16b-a3b (MoE) over every visible card
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch moonshot-v1-16b-a3b --reduced --steps 3 --global-batch 8 \\
      --seq-len 128
  PYTHONPATH=src python -m repro_torch.launch.train --fl --dataset mnist \\
      --policy dqre_sc --rounds 30
"""

from __future__ import annotations

import argparse
import time


def train_lm(args) -> None:
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenDataConfig, make_batch_iterator
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (make_optimizer, make_train_step,
                                          num_microbatches)
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import shard_params
    from repro_torch.tree import leaves

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("custom_train", args.seq_len, args.global_batch,
                        "train", args.microbatches)

    n_dev = 1 if dev.type == "cpu" else torch.cuda.device_count()
    mesh = make_test_mesh(data=n_dev, model=1, device=dev)
    opt = make_optimizer(cfg, args.steps)
    step_fn = make_train_step(cfg, shape, opt, mesh=mesh)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    init = ED.init_encdec if cfg.is_encoder_decoder else T.init_lm
    params = shard_params(init(gen, cfg, device=dev), mesh)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M devices={n_dev} "
          f"device={','.join(str(d) for d in mesh.devices)}")

    data_cfg = TokenDataConfig(cfg.vocab_size, args.seq_len,
                               args.global_batch, seed=args.seed)
    it = make_batch_iterator(data_cfg, num_batches=args.steps, mesh=mesh,
                             microbatches=num_microbatches(cfg, shape,
                                                           n_dev))
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    t0 = time.time()
    for step, shards in enumerate(it):
        if cfg.is_encoder_decoder:
            # the stub frontend's frames: zeros, as the JAX launcher
            # feeds, split with their batch
            shards = [dict(s, src_embeds=torch.zeros(
                (s["tokens"].shape[0], args.seq_len, cfg.d_model),
                dtype=L.dtype_of(cfg.compute_dtype), device=d))
                for s, d in zip(shards, mesh.devices)]
        params, opt_state, metrics = step_fn(params, opt_state, step,
                                             shards)
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            tok_s = args.global_batch * args.seq_len * (step + 1) / dt
            print(f"step {step:5d}  loss {loss:.4f}  {tok_s:,.0f} tok/s")
        if ckpt and step and step % args.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt_state": opt_state},
                      {"loss": float(metrics['loss'])})
    print(f"done in {time.time()-t0:.1f}s; final loss "
          f"{float(metrics['loss']):.4f}")
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt_state": opt_state})


def train_fl(args) -> None:
    from repro_torch.fed.rounds import FederatedRunner, RunnerConfig

    cfg = RunnerConfig(dataset=args.dataset, policy=args.policy,
                       sigma=args.sigma, num_clients=args.num_clients,
                       clients_per_round=args.clients_per_round,
                       target_accuracy=args.target_accuracy, seed=args.seed)
    runner = FederatedRunner(cfg, device=args.device)
    print(f"FL: {args.dataset} sigma={args.sigma} policy={args.policy} "
          f"clients={args.num_clients} cohort={args.clients_per_round} "
          f"device={runner.device}")
    for _ in range(args.rounds):
        res = runner.run_round()
        print(f"round {res.round_idx:4d}  acc {res.accuracy:.4f}  "
              f"reward {res.reward:+.3f}  ({res.seconds:.1f}s)")
        if res.accuracy >= args.target_accuracy:
            print(f"target {args.target_accuracy} reached at round "
                  f"{res.round_idx + 1}")
            break
    print("final metrics:", runner.final_metrics())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fl", action="store_true")
    # LM mode
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    # FL mode
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--policy", default="dqre_sc",
                    choices=["fedavg", "kcenter", "favor", "dqre_sc"])
    ap.add_argument("--sigma", type=float, default=0.5)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--num-clients", type=int, default=100)
    ap.add_argument("--clients-per-round", type=int, default=10)
    ap.add_argument("--target-accuracy", type=float, default=0.85)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    (train_fl if args.fl else train_lm)(args)


if __name__ == "__main__":
    main()
