#!/usr/bin/env python3
"""The dry run of the four-card configurations ``chip_smoke.py`` runs on
the cards (phases 12d, 13c, 14b, 15b-d), on the host, no card touched.

    python3 scripts/dryrun_cells.py [--only LABEL ...] [--out FILE]

Each cell is the card run's own configuration (arch, depth cut, batch,
sequence, mesh), taken from ``chip_smoke.py``'s constants: the training
cells run one step of phase 11a's batch (8 x 256 tokens, 2
microbatches) on the mesh; the serving cells run one prefill of the
card run's prompt (a prefill bundle's cache holds just its prompt, and
the encoder-decoder's prompt is as long as its source, the 1024 frames
of the card run, where the card's prompt is 128 tokens), then one
decode step over the card run's cache (the encoder-decoder's rows in
lockstep; the long-context decode from the cache's last row).  For
each it prints, by fake device, the bytes after placement and the peak
(``launch/steps.py::lower_step``, the step counted by
``roofline/counting.py``), whether the busiest device fits
``roofline/analysis.py::HW.hbm_bytes``, the bottleneck of the counted
roofline and the host seconds, and writes every row as JSON to
``--out``.  These are host-side predictions, not card readings.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def cells(cs):
    """(label, arch, layers or None, [(kind, seq, batch)], (data, model))
    for each four-card card run of ``chip_smoke`` (``cs``)."""
    from repro_torch.configs import get_config

    train = [("train", cs.TRAIN_SEQ, cs.TRAIN_BATCH)]
    out = [("12d", cs.MESH_4_ARCH, None, train, (cs.MESH_4_CARDS, 1))]
    out += [(f"13c {arch}", arch, None, train, mesh)
            for arch, mesh in cs.TP_4_FULL]
    out += [(f"14b {arch}", arch, layers, train, mesh)
            for arch, mesh, layers in cs.MOE_4_FULL]
    # a prefill bundle's prompt fills its cache: the card's prompt length
    serve = [("prefill", cs.SERVE_4_PROMPT, cs.SERVE_4_ROWS),
             ("decode", cs.SERVE_4_CACHE, cs.SERVE_4_ROWS)]
    # the encoder-decoder's prompt as long as its source: the encoder's
    # 1024 frames fill the cross cache
    frames = get_config(cs.ENCDEC_ARCH).encoder_seq_len
    encdec = [("prefill", frames, cs.ENCDEC_BATCH),
              ("decode", cs.ENCDEC_SEQ, cs.ENCDEC_BATCH)]
    out += [(f"15b {arch}", arch, None, serve, mesh)
            for arch, mesh in cs.SERVE_4]
    out += [(f"15c {arch}", arch, layers,
             encdec if arch == cs.ENCDEC_ARCH else serve, mesh)
            for arch, mesh, layers in cs.SERVE_4C]
    out.append(("15d", cs.LONG_ARCH, None, [("decode", None, 1)], (2, 2)))
    # 15c's MLA cell at full depth: whether the 61 layers fit four cards
    arch, mesh, _ = cs.SERVE_4C[0]
    out.append((f"15c-full {arch}", arch, None, serve, mesh))
    return out


def run_cell(label, arch, layers, kinds, sizes):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.roofline.analysis import (HW, collective_bytes,
                                               extract_cost, memory_of,
                                               roofline_report)

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    mesh = make_test_mesh(*sizes, device="meta")
    rows = []
    for kind, seq, batch in kinds:
        if seq is None:
            shape = get_shape("long_500k")
        else:
            shape = ShapeConfig("custom_train" if kind == "train" else
                                "serve", seq, batch, kind,
                                2 if kind == "train" else 1)
        t0 = time.perf_counter()
        lowered = steps.lower_step(steps.build_step(cfg, shape, mesh), mesh)
        with ops.use_pallas_scoped(kind != "train"):
            count = lowered.run()
        rec = {"memory": memory_of(count), "cost": extract_cost(count),
               "collectives": collective_bytes(count)}
        roof = roofline_report(cfg, shape, mesh, rec)
        row = {"cell": label, "arch": arch, "layers": cfg.num_layers,
               "kind": kind, "seq": shape.seq_len,
               "batch": shape.global_batch, "mesh": list(sizes),
               "argument_bytes": count.argument_bytes,
               "peak_bytes": count.peak_bytes,
               "fits": max(count.peak_bytes) <= HW.hbm_bytes,
               "bottleneck": roof["bottleneck"],
               "collective_bytes": rec["collectives"]["total_bytes"],
               "seconds": round(time.perf_counter() - t0, 1)}
        rows.append(row)
        print(f"{label} {kind} ({cfg.num_layers} layers, {shape.global_batch}"
              f" x {shape.seq_len}, mesh {sizes}): args "
              + ", ".join(f"{b / 2**30:.2f}" for b in count.argument_bytes)
              + " GiB; peak "
              + ", ".join(f"{b / 2**30:.2f}" for b in count.peak_bytes)
              + f" GiB; {'fits' if row['fits'] else 'does not fit'}; "
              f"{row['bottleneck']}-bound; {row['seconds']} s",
              flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="labels (or their first word) to run")
    ap.add_argument("--out", default="experiments/dryrun_cells.json")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke as cs

    rows = []
    for label, *rest in cells(cs):
        if args.only and label not in args.only \
                and label.split()[0] not in args.only:
            continue
        rows += run_cell(label, *rest)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
