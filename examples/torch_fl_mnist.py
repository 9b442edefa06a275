"""End-to-end paper reproduction driver of the PyTorch/CUDA port (Tables
2/3 workflow).

Runs all four selection policies on one dataset/sigma with identical
seeds and reports rounds-to-target + final metrics — the paper's core
experiment.  The port's twin of ``examples/fl_mnist.py``: the same
flags, defaults, report and JSON, plus each policy's wall seconds.  It
runs on the card unless ``--device cpu`` is given; ``--use-pallas``
runs every dqre_sc solve's pairwise distances through the hand-written
kernel.  Scale knobs default to CPU-friendly values; the paper's scale
is ``--clients 100 --cohort 10 --train-size 60000``.

  PYTHONPATH=src python examples/torch_fl_mnist.py --dataset mnist \
      --sigma 0.8 --rounds 20 --use-pallas
  PYTHONPATH=src python examples/torch_fl_mnist.py --device cpu
"""

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

POLICIES = ("fedavg", "kcenter", "favor", "dqre_sc")


def main(argv=None):
    """Returns {"results": the JSON written, "path": where, "runs":
    {policy: {"seconds", "median_round_seconds", "solves"}}}: "solves"
    counts the policy's Algorithm I solves (dqre_sc; 0 for the others)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "fashion_mnist", "cifar10"])
    ap.add_argument("--sigma", type=float, default=0.8)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--cohort", type=int, default=5)
    ap.add_argument("--target", type=float, default=None)
    ap.add_argument("--train-size", type=int, default=2500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/fl")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run dqre_sc's pairwise distances through the "
                         "hand-written kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.fed.rounds import FederatedRunner, RunnerConfig

    device = resolve_device(args.device)
    target = args.target if args.target is not None else \
        {"mnist": 0.9, "fashion_mnist": 0.8, "cifar10": 0.6}[args.dataset]

    results, runs = {}, {}
    for policy in POLICIES:
        cfg = RunnerConfig(dataset=args.dataset, policy=policy,
                           sigma=args.sigma, num_clients=args.clients,
                           clients_per_round=args.cohort,
                           target_accuracy=target, seed=args.seed,
                           train_size=args.train_size, eval_size=512,
                           local_steps=8, batch_size=16, embed_dim=8,
                           num_clusters=max(2, args.cohort - 1),
                           use_pallas=args.use_pallas)
        t0 = time.perf_counter()
        runner = FederatedRunner(cfg, device=device)
        runner.run(args.rounds, stop_at_target=True)
        rounds = runner.rounds_to_accuracy()
        final = runner.history[-1].accuracy
        results[policy] = {
            "rounds_to_target": rounds,
            "final_accuracy": final,
            "curve": [h.accuracy for h in runner.history],
            "metrics": runner.final_metrics(),
        }
        seconds = time.perf_counter() - t0
        runs[policy] = {
            "seconds": seconds,
            "median_round_seconds": statistics.median(
                h.seconds for h in runner.history),
            "solves": getattr(runner.policy, "cluster_computes", 0),
        }
        print(f"{policy:10s}: rounds_to_{target:.2f} = "
              f"{rounds if rounds else f'>{args.rounds}'}  "
              f"final_acc = {final:.4f}  ({seconds:.1f}s, median round "
              f"{runs[policy]['median_round_seconds']:.3f}s)")

    base = results["fedavg"]["rounds_to_target"] or args.rounds
    ours = results["dqre_sc"]["rounds_to_target"] or args.rounds
    print(f"\ncommunication-round reduction vs FedAvg: "
          f"{100 * (1 - ours / base):.0f}%  "
          f"(paper reports 51/25/44% on real MNIST/FMNIST/CIFAR-10)")

    os.makedirs(args.out, exist_ok=True)
    name = f"{args.dataset}_sigma{args.sigma}_seed{args.seed}.json"
    path = os.path.join(args.out, name)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {path}")
    return {"results": results, "path": path, "runs": runs}


if __name__ == "__main__":
    main()
