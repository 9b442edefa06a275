"""Quickstart of the PyTorch/CUDA port: the paper's pipeline end to end.

1. spectrally cluster synthetic client weight-embeddings (Algorithm I),
2. run three federated communication rounds with DQRE-SCnet selection,
3. hold a hand-written kernel (the RBF affinity) against its plain
   PyTorch version.

The port's twin of ``examples/quickstart.py``.  It runs on the card
unless ``--device cpu`` is given; on the CPU step 3's wrapper runs the
kernel's plain version.  ``--use-pallas`` also routes steps 1 and 2's
affinities through the pairwise-distance kernel.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

# every draw of the quickstart: the blobs, k-means and step 3's input
SEED = 0
# step 3's kernel against its plain version: max |err| over the largest
# entry (the kernel tests' limit for the RBF affinity)
LIMIT_AFFINITY_REL = 1e-4


def three_blobs():
    """Three synthetic client groups in weight-embedding space, (60, 2)."""
    rng = np.random.default_rng(SEED)
    return np.concatenate([rng.normal(size=(20, 2)) + c
                           for c in ([0, 0], [8, 0], [4, 7])]).astype(
                               np.float32)


def demo_spectral_clustering(device, use_pallas=False):
    """Algorithm I on :func:`three_blobs`; returns (assignments, eigengap
    k)."""
    from repro_torch.core.spectral import eigengap_k, spectral_cluster
    print("== 1. Spectral clustering (Algorithm I) ==")
    x = three_blobs()
    assign, _, evals = spectral_cluster(torch.Generator().manual_seed(SEED),
                                        torch.as_tensor(x, device=device), 3,
                                        use_pallas=use_pallas)
    assign = assign.cpu().numpy()
    k_hat = eigengap_k(evals.cpu())
    print(f"  clusters found sizes: {np.bincount(assign)}, "
          f"eigengap suggests k={k_hat}")
    return assign, k_hat


def demo_federated_rounds(device, use_pallas=False):
    """Three DQRE-SCnet rounds; returns their ``RoundResult``s."""
    from repro_torch.fed.rounds import FederatedRunner, RunnerConfig
    print("== 2. Federated rounds with DQRE-SCnet selection ==")
    cfg = RunnerConfig(dataset="mnist", num_clients=12, clients_per_round=4,
                       sigma=0.8, local_steps=6, batch_size=16,
                       train_size=1500, eval_size=256, policy="dqre_sc",
                       num_clusters=3, embed_dim=4, seed=0,
                       use_pallas=use_pallas)
    runner = FederatedRunner(cfg, device=device)
    rounds = []
    for _ in range(3):
        res = runner.run_round()
        rounds.append(res)
        cohort = sorted(res.selected.tolist())
        print(f"  round {res.round_idx}: acc={res.accuracy:.3f} "
              f"reward={res.reward:+.3f} cohort={cohort}")
    return rounds


def demo_kernel_validation(device):
    """The RBF affinity kernel (its plain version on the CPU) against the
    plain version on the CPU; returns (x, the kernel's output, max |err|)."""
    from repro_torch.kernels import ops, ref
    route = "CUDA" if device.type == "cuda" else "plain on the CPU"
    print(f"== 3. Hand-written kernel vs its plain version ({route}) ==")
    x = torch.randn((64, 8), generator=torch.Generator().manual_seed(SEED))
    got = ops.rbf_affinity(x.to(device), 0.5)
    want = ref.rbf_affinity_ref(x, 0.5)
    err = float((got.cpu() - want).abs().max())
    print(f"  affinity kernel max |err| = {err:.2e}")
    if err > LIMIT_AFFINITY_REL * float(want.abs().max()):
        raise AssertionError(f"the affinity kernel is off by {err:.2e}")
    return x, got, err


def main(argv=None):
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--use-pallas", action="store_true",
                    help="route steps 1 and 2's affinities through the "
                         "pairwise-distance kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    assign, k_hat = demo_spectral_clustering(device, args.use_pallas)
    rounds = demo_federated_rounds(device, args.use_pallas)
    x, affinity, err = demo_kernel_validation(device)
    print("quickstart OK")
    return {"assign": assign, "k_hat": k_hat, "rounds": rounds, "x": x,
            "affinity": affinity, "affinity_err": err}


if __name__ == "__main__":
    main()
