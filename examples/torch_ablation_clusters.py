"""Ablation of the PyTorch/CUDA port: DQRE-SCnet cluster-count sensitivity
+ eigengap auto-k.

The paper fixes its cluster count implicitly and mentions the eigengap
heuristic (§3.4) without ablating it.  This driver compares fixed
k ∈ {2, 4, 8} against eigengap-chosen k on one dataset/σ.  The port's
twin of ``examples/ablation_clusters.py``, which also prints the k̂ of
each variant's last solve.  It runs on the card unless ``--device cpu``
is given; ``--use-pallas`` runs every solve's pairwise distances through
the hand-written kernel.

  PYTHONPATH=src python examples/torch_ablation_clusters.py --rounds 12
  PYTHONPATH=src python examples/torch_ablation_clusters.py --device cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

VARIANTS = (("k=2", {"num_clusters": 2}),
            ("k=4", {"num_clusters": 4}),
            ("k=8", {"num_clusters": 8}),
            ("eigengap(<=8)", {"num_clusters": 8, "auto_k": True}))


def main(argv=None):
    """Returns {variant: {"rounds_to_target", "final_accuracy", "k_hat",
    "solves"}}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--sigma", type=float, default=0.8)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the solves' pairwise distances through the "
                         "hand-written kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.fed.rounds import FederatedRunner, RunnerConfig

    device = resolve_device(args.device)
    out = {}
    for name, kw in VARIANTS:
        cfg = RunnerConfig(dataset=args.dataset, policy="dqre_sc",
                           sigma=args.sigma, num_clients=20,
                           clients_per_round=5, local_steps=8,
                           batch_size=16, train_size=2500, eval_size=384,
                           target_accuracy=0.9, seed=args.seed,
                           policy_kwargs=kw, use_pallas=args.use_pallas)
        runner = FederatedRunner(cfg, device=device)
        runner.run(args.rounds, stop_at_target=True)
        rounds = runner.rounds_to_accuracy()
        engine = runner.policy.engine
        out[name] = {"rounds_to_target": rounds,
                     "final_accuracy": runner.history[-1].accuracy,
                     "k_hat": engine.state.result.k,
                     "solves": engine.stats["solves"]}
        print(f"{name:15s}: rounds_to_0.90 = "
              f"{rounds if rounds else f'>{args.rounds}'}  "
              f"final = {runner.history[-1].accuracy:.4f}  "
              f"k_hat = {out[name]['k_hat']}")
    return out


if __name__ == "__main__":
    main()
