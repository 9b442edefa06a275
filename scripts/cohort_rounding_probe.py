#!/usr/bin/env python3
"""How the cohort server's cold solve reacts to the last bits of B3's
rotated Gram, on one card.

    python3 scripts/cohort_rounding_probe.py

Runs the m=512 engine of ``chip_smoke.py`` phase 3 (the same table and
engine seed) on the card and on the CPU and prints how far apart their
W⁻¹ᐟ², u and rotated Gram W⁻¹ᐟ²·SᵀS·W⁻¹ᐟ² are.  Then it takes the card's
W⁻¹ᐟ² and u, computes SᵀS on the card (B3 with an identity rotation,
which returns SᵀS itself), and rotates it four ways: B3's own rotation
(k ascending, one accumulator), B5's panel kernel (a k-split sum), the
CPU's f32 matmul and float64.  Each rotated Gram is handed to the CPU
engine (with the card's W⁻¹ᐟ²) and the cold solve's purity against
the true blobs printed.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cohort_rounding_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.cohort import CohortConfig, CohortEngine
    from repro_torch.cohort import nystrom as cn
    from repro_torch.kernels import nystrom as kn
    from repro_torch.kernels import ops, ref

    print("card", cs.card_line())
    x, labels = cs.blobs(np.random.default_rng(cs.SEED))
    config = CohortConfig(num_clusters=cs.K, method="nystrom",
                          use_pallas=True, num_landmarks=cs.M)
    seen = {}
    gram = ops.nystrom_gram

    def solve(dev, rotated=None, w_isqrt=None):
        """One cold select; records the Gram call's inputs and output.
        ``rotated`` replaces the rotated Gram, ``w_isqrt`` W⁻¹ᐟ²."""
        def recording(x_, z, gamma, u, w, mask=None, **kw):
            out = gram(x_, z, gamma, u, w, mask, **kw)
            seen[dev] = dict(x=x_, z=z, gamma=gamma, u=u, w=w, mm=out)
            return out if rotated is None else rotated.to(out.device)

        isqrt = cn.landmark_block_isqrt

        def fixed_isqrt(*a, **k):
            w, basis = isqrt(*a, **k)
            return w if w_isqrt is None else w_isqrt.to(w.device), basis

        ops.nystrom_gram, cn.landmark_block_isqrt = recording, fixed_isqrt
        try:
            res = CohortEngine(config, seed=cs.ENGINE_SEED,
                               device=dev).select(x)
        finally:
            ops.nystrom_gram, cn.landmark_block_isqrt = gram, isqrt
        return float(cs.purity(res.assign, labels))

    card, cpu = solve("cuda"), solve("cpu")
    c, p = seen["cuda"], seen["cpu"]

    def gap(k):
        return float((c[k].cpu() - p[k]).abs().max())

    mm_c, mm_p = c["mm"].cpu(), p["mm"]
    print(f"cold purity: card {card:.5f}, CPU {cpu:.5f}")
    print(f"card vs CPU: W^-1/2 max |diff| {gap('w'):.4g}, u {gap('u'):.4g},"
          f" rotated Gram {float(torch.linalg.norm(mm_c - mm_p) / torch.linalg.norm(mm_p)):.4g}"
          f" relative Frobenius")

    # S^T S on the card, then four rotations of it with the card's W^-1/2
    w = c["w"]
    eye = torch.eye(w.shape[0], device=w.device)
    g = kn.nystrom_gram(c["x"], c["z"], c["gamma"], c["u"], eye)
    torch.cuda.synchronize()
    print(f"B3 with an identity rotation: S^T S exactly symmetric "
          f"{bool(torch.equal(g, g.T))}")
    wc, gc = w.cpu(), g.cpu()
    rotations = {
        "B3 (k ascending)": kn.nystrom_gram(c["x"], c["z"], c["gamma"],
                                            c["u"], w).cpu(),
        "B5 panel kernel (k split)": kn.panel_matmul(
            kn.panel_matmul(w, g), w).cpu(),
        "CPU f32 matmul": wc @ gc @ wc,
        "float64": (wc.double() @ gc.double() @ wc.double()).float(),
    }
    exact = rotations["float64"].double()
    for name, mm in rotations.items():
        err = float(torch.linalg.norm(mm.double() - exact)
                    / torch.linalg.norm(exact))
        purity = solve("cpu", rotated=mm, w_isqrt=wc)
        print(f"card W^-1/2, rotation {name:26s}: {err:.3e} from float64, "
              f"cold purity {purity:.5f}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
