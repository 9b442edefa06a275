"""Training launcher of the port: federated (FL) training.

``--fl`` runs the paper's federated workflow: DQRE-SCnet (or a baseline
policy) selects the cohort every communication round.  The flags are the
JAX package's ``repro.launch.train`` flags plus ``--device`` (``"cuda"``
unless given; ``--device cpu`` runs the plain PyTorch path on the CPU).
The distributed LM training mode is not ported yet (ROADMAP §A5).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --fl --dataset mnist \\
      --policy dqre_sc --rounds 30
"""

from __future__ import annotations

import argparse


def train_lm(args) -> None:
    raise NotImplementedError(
        "LM training is not ported to repro_torch yet (ROADMAP §A5: LM "
        "training); run it with `python -m repro.launch.train`, or pass --fl")


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
    # LM mode (not ported: kept so the JAX package's command lines parse)
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
