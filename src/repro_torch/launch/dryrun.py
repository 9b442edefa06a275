"""Dry run: every (arch x shape x production mesh) run once on fake
devices, on the host, touching no card.

The port's counterpart of the JAX package's ``launch/dryrun.py`` (which
AOT-lowers and compiles for the TPU pods).  For each combination it:

  1. builds the production mesh on fake devices
     (``launch/mesh.py::make_production_mesh(device="meta")``: one
     8-card H100 host as (data 2, model 4), or two hosts as (pod 2,
     data 2, model 4));
  2. assembles the step bundle (``launch/steps.py::build_step``: meta
     tensors and the sharding rules, nothing allocated) and places its
     arguments as fake tensors with the placement a real run uses
     (``lower_step``);
  3. runs the step once on them under ``roofline/counting.py``'s
     counter, so the layout, memory, FLOP, byte and copy figures come
     from the code that runs on the cards;
  4. records per-device memory (whether it fits the card's
     ``roofline.analysis.HW.hbm_bytes``), FLOPs and bytes, the bytes
     copied between cards by kind, a roofline of those counts and the
     analytic ``roofline/calculator.py`` terms;
  5. writes one JSON record per combination under ``--out``.

With ``--use-pallas`` the step takes the kernels' routes, as
``launch/serve.py --use-pallas`` does: flash attention (B9) and the SSD
chunk (B10) answer a fake tensor with an empty output of their shape and
count their work in closed form (``kernels/flash_attention.py::
flash_work``, ``kernels/ssd.py::ssd_work``).  Training is differentiated
and keeps the plain route either way.  Three plain calls answer fake
tensors by replaying their own op-by-op count, taken once per signature
(``roofline/counting.py::counted_call``): the blocked attention
(``models/attention.py::blocked_attention``, at 2048 query rows and
more), the SSD scan (``models/mamba.py::_ssd_chunked``) and each layer
of a mesh's training loss (``models/transformer.py::checkpoint_tp``):
the same FLOPs, bytes, copies and peaks at a few dispatches a call.
Each record's ``memory`` lists what the busiest device holds at its
peak, by the op that made it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --use-pallas --skip-existing
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback


def _run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             use_pallas: bool = False, verbose: bool = True) -> dict:
    """One combination's record, written to ``out_dir``."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_production_mesh, mesh_name
    from repro_torch.launch.steps import (build_step, lower_step,
                                          num_microbatches)
    from repro_torch.roofline.analysis import (HW, collective_bytes,
                                               extract_cost, memory_of,
                                               roofline_report)
    from repro_torch.roofline.calculator import roofline_terms

    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    name = mesh_name(mesh)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "num_devices": mesh.size, "use_pallas": use_pallas,
           "status": "ok"}
    try:
        cfg = get_config(arch)
        shape = get_shape(shape_name)
        bundle = build_step(cfg, shape, mesh)
        lowered = lower_step(bundle, mesh)
        rec["place_seconds"] = round(lowered.place_seconds, 1)
        with ops.use_pallas_scoped(use_pallas):
            count = lowered.run()
        rec["run_seconds"] = round(count.seconds, 1)
        rec["memory"] = memory_of(count)
        rec["fits"] = rec["memory"]["peak_bytes"] <= HW.hbm_bytes
        rec["cost"] = extract_cost(count)
        rec["collectives"] = collective_bytes(count)
        rec["kernels"] = count.kernels
        rec["routes"] = count.routes
        rec["roofline_counted"] = roofline_report(cfg, shape, mesh, rec)
        rec["roofline"] = roofline_terms(
            cfg, shape, mesh, num_microbatches(cfg, shape,
                                               len(mesh.replicas)))
        if verbose:
            m, r = rec["memory"], rec["roofline_counted"]
            print(f"[ok] {arch} x {shape_name} x {name}: args "
                  f"{m['argument_bytes'] / 2**30:.2f} GiB/dev, peak "
                  f"{m['peak_bytes'] / 2**30:.2f} GiB/dev "
                  f"({'fits' if rec['fits'] else 'does not fit'} "
                  f"{HW.hbm_bytes / 1e9:.0f} GB) | compute "
                  f"{r['compute_s'] * 1e3:.2f} ms, memory "
                  f"{r['memory_s'] * 1e3:.2f} ms, collective "
                  f"{r['collective_s'] * 1e3:.2f} ms -> "
                  f"{r['bottleneck']}-bound (place "
                  f"{rec['place_seconds']}s, run {rec['run_seconds']}s)")
    except Exception as e:  # noqa: BLE001 -- record and go on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {name}: {rec['error']}")

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__{name}.json"),
              "w") as f:
        json.dump({k: v for k, v in rec.items() if k != "traceback"}, f,
                  indent=2, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run of every arch x shape x production mesh on "
                    "fake devices (no card).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) combination")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--use-pallas", action="store_true",
                    help="the kernels' routes (B9, B10), as serving runs "
                         "them")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, list_archs
    from repro_torch.launch.mesh import make_production_mesh, mesh_name

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                name = mesh_name(make_production_mesh(multi_pod=multi,
                                                      device="meta"))
                path = os.path.join(args.out, f"{arch}__{shape}__{name}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            print(f"[skip] {arch} x {shape} x {name}")
                            continue
                rec = _run_one(arch, shape, multi, args.out,
                               use_pallas=args.use_pallas)
                failures += rec["status"] != "ok"
    print(f"\ndry run complete in {time.time() - t0:.0f} s; {failures} "
          f"failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
