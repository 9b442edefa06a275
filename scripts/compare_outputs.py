#!/usr/bin/env python3
"""Save B1's, B2's, B4's, B6's, B7's and B8's outputs at chip_smoke.py's
hashed phase-2 cases, or compare them with saved ones, on one card.

    python3 scripts/compare_outputs.py [--tree DIR] PATH

The cases are those whose SHA-256 ``chip_smoke.py`` prints in phase 2,
on the same inputs: for B1 (cross-affinity), B2 (colsum) and B4
(extension) ``path``, ``ragged`` and ``m640`` at f32, bf16 and int8,
and the m=4096 engine's shape at f32; for B6 (RBF cross-affinity) the
unfused Nyström path's C (10⁵ x 512), a ragged 37 x 21 and the m=4096
engine's W block; for B7 (pairwise squared distances) the fed loop's
100 x 100, the dense path's 2048 x 2048 and a ragged 37 x 21; for B8
(square RBF affinity) the dense path's 2048 points and a ragged 37.  The
kernels are those of
``DIR/src/repro_torch`` (default: this checkout), built there on first
use; a parent commit unpacked with ``git archive`` under ``build/`` is
the usual DIR.  When PATH (.npz) does not exist the outputs are saved
there; when it does, each case is printed as bit-identical to the saved
output, or with its largest |difference| (absolute, and over the saved
output's largest entry), then the largest over every case.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def outputs():
    """{"name shape dtype": numpy array} over the hashed cases."""
    import chip_smoke as cs

    x, _, gamma = cs.path_data()
    cases = [(shape, dtype, t, t["mask"])
             for shape, t in cs.phase2_inputs(x, gamma).items()
             for dtype in cs.DTYPES]
    cases.append((f"m{cs.M_SUBSPACE}", "f32",
                  cs.m4096_inputs(x, gamma)[1], None))
    got = {}

    def keep(name, case, out):
        cs.print_hash(name, case, out)
        got[f"{name} {case}"] = out.detach().cpu().numpy()

    for shape, dtype, t, mask in cases:
        calls = cs._calls(t, dtype, mask)
        for name in cs.HASHED:
            keep(name, f"{shape} {dtype}", calls[name][0]())
    from repro_torch.kernels import ops
    inputs = cs.slice2_inputs(x)
    for label, (_, a, b) in cs.cross_cases(inputs).items():
        keep("rbf_cross_affinity", f"{label} f32",
             ops.rbf_cross_affinity(a, b, gamma))
    for label, (_, a, b) in cs.dist_cases(inputs).items():
        keep("pairwise_sq_dists", f"{label} f32", ops.pairwise_sq_dists(a, b))
    for label, (_, a) in cs.square_cases(inputs).items():
        keep("rbf_affinity", f"{label} f32", ops.rbf_affinity(a, gamma))
    return got


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("path", type=pathlib.Path)
    parser.add_argument("--tree", type=pathlib.Path, default=REPO,
                        help="the checkout whose kernels run")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_outputs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    import repro_torch
    print(f"kernels of {pathlib.Path(repro_torch.__file__).parent}")
    got = outputs()
    if not args.path.is_file():
        args.path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(args.path, **got)
        print(f"saved {len(got)} outputs to {args.path}")
        return 0
    worst = {}
    with np.load(args.path) as saved:
        for key, a in got.items():
            old = saved[key]
            if old.shape != a.shape:
                raise SystemExit(f"{key}: shape {a.shape} != saved "
                                 f"{old.shape}")
            name = key.split()[0]
            if old.tobytes() == a.tobytes():
                delta = 0.0
                print(f"{key}: bit-identical to the saved output")
            else:
                delta = float(np.abs(a - old).max())
                print(f"{key}: largest |difference| {delta:.3e} "
                      f"({delta / float(np.abs(old).max()):.3e} of the "
                      f"saved output's largest entry)")
            worst[name] = max(worst.get(name, 0.0), delta)
    for name, delta in worst.items():
        print(f"{name}: largest |difference| over every case {delta:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
