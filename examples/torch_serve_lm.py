"""Serve a small LM through the PyTorch/CUDA port's continuous-batching
decode engine.

Mixed-length requests flow through the DecodeScheduler's slot table —
admitted via slot-targeted prefill, decoded with per-request cache
positions, retired mid-decode — on a reduced model.  Pass
``--requests`` > ``--batch`` to watch the queue drain through the
slots.  The port's twin of ``examples/serve_lm.py``: the same requests
from the same seed.  It runs on the card unless ``--device cpu`` is
given; ``--use-pallas`` runs every prefill's attention through the
flash-attention kernel and every Mamba-2 layer's through the SSD kernel.
``--prompt-multiple 8`` rounds each drawn prompt length up to a multiple
of 8, the prefill bucket: the bucket's padding runs through a Mamba-2
recurrence, so an SSM arch answers a padded prompt otherwise than its
unpadded one.

  PYTHONPATH=src python examples/torch_serve_lm.py --batch 4 --requests 10
  PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2-2.7b \
      --requests 10 --prompt-multiple 8 --use-pallas
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np


def main(argv=None):
    """Returns {"done": the answered requests, "stats": the server's
    stats, "cfg": the reduced config, "seconds": the serving wall time}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default: one per slot)")
    ap.add_argument("--prompt-multiple", type=int, default=1,
                    help="round each prompt length up to a multiple of this")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the prefill through the flash-attention and "
                         "SSD kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, Server

    cfg = get_config(args.arch).reduced()
    server = Server(cfg, args.batch, args.prompt_len + args.gen_len,
                    temperature=args.temperature, seed=args.seed,
                    device=args.device)
    rng = np.random.default_rng(args.seed)
    m = args.prompt_multiple
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    -(-rng.integers(4, args.prompt_len)
                                      // m) * m)
                    .astype(np.int32), int(rng.integers(1, args.gen_len + 1)))
            for i in range(args.requests or args.batch)]
    t0 = time.time()
    with ops.use_pallas_scoped(args.use_pallas):
        done = server.serve_batch(reqs)
    dt = time.time() - t0
    s = server.stats()
    print(f"served {len(done)} requests in {dt:.1f}s "
          f"({server.last_decode_tok_s:,.1f} decode tok/s; "
          f"{s['decode_steps']} decode steps over {s['slots']} slots)")
    for r in done:
        print(f"  req {r.uid} (prompt {len(r.prompt)} toks) -> "
              f"{r.generated[:8]}...")
    return {"done": done, "stats": s, "cfg": cfg, "seconds": dt}


if __name__ == "__main__":
    main()
