"""The card's peak rates, the analytic useful-FLOP count, and the dry
run's records read from its counts.

Port of the JAX package's ``roofline/analysis.py``.  Where the JAX dry
run reads an AOT-compiled module (``compiled.cost_analysis()`` and the
collectives parsed from its HLO text), the port's dry run runs the step
once on fake tensors under ``roofline/counting.py::StepCounter``
(``launch/steps.py::lower_step``), and :func:`memory_of`,
:func:`extract_cost` and :func:`collective_bytes` read what it counted.
:func:`roofline_report` turns one record into the three terms, in
seconds, for the busiest device:

  compute    = FLOPs / peak                 peak = 989e12 bf16 (67e12 f32)
  memory     = bytes accessed / HBM rate    3.35e12 B/s
  collective = bytes a device sends or receives / NVLink rate  450e9 B/s

:data:`HW` keeps the JAX table's field names, with the values of an
NVIDIA H100 SXM5 (80 GB HBM3, 700 W) in place of the TPU v5e's.
``roofline/calculator.py``'s analytic model is the other roofline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class _HW:
    """NVIDIA H100 SXM5 datasheet values for the 700 W part: dense (not
    sparse) tensor-core bf16 and CUDA-core f32 FLOP/s, HBM3 bytes/s,
    NVLink 4 bytes/s in one direction per card (900 GB/s both ways),
    and the card's memory."""

    peak_flops: float = 989e12        # bf16 dense FLOP/s per card
    peak_flops_f32: float = 67e12     # f32 (non-tensor) FLOP/s per card
    hbm_bw: float = 3.35e12           # bytes/s per card
    ici_bw: float = 450e9             # NVLink bytes/s per direction a card
    hbm_bytes: float = 80e9           # the card's memory


HW = _HW()

#: the (op, dtype, shape) groups a record lists at the peak
PEAK_GROUPS = 20


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs: 6·N·D train, 2·N·D prefill, 2·N·B decode
    (N = active params for MoE)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def memory_of(count) -> dict:
    """The JAX record's ``memory`` from a ``StepCount``: the argument,
    output, temporary and peak bytes of the device with the largest peak
    (temp = peak - arguments, as the JAX record's peak = arguments +
    temp), then under ``per_device`` each one's, in mesh order; then
    what that device held at its peak: ``peak_by_op``, bytes by the op
    that made them, and ``peak_by_tensor``, the largest (op, dtype,
    shape) groups."""
    per = {"argument_bytes": count.argument_bytes,
           "output_bytes": count.output_bytes,
           "temp_bytes": count.temp_bytes, "peak_bytes": count.peak_bytes}
    top = max(range(len(count.devices)), key=count.peak_bytes.__getitem__)
    out = {k: v[top] for k, v in per.items()}
    out["device"] = count.devices[top]
    out["per_device"] = {k: list(v) for k, v in per.items()}
    groups = count.peak_by_op[top]
    by_op: Dict[str, int] = {}
    for (op, _, _), n in groups.items():
        by_op[op] = by_op.get(op, 0) + n
    out["peak_by_op"] = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
    out["peak_by_tensor"] = [
        {"op": op, "shape": f"{str(dtype)[6:]}{list(shape)}", "bytes": n}
        for (op, dtype, shape), n in
        sorted(groups.items(), key=lambda kv: -kv[1])[:PEAK_GROUPS]]
    return out


def extract_cost(count) -> Dict[str, float]:
    """FLOPs and bytes accessed of the busiest device (the most FLOPs;
    the most bytes), then under ``per_device`` each one's, from a
    ``StepCount``: the counterpart of the JAX ``cost_analysis()``, which
    is per device.  ``bytes_accessed`` is the eager program's traffic,
    with no fusion (``roofline/counting.py``)."""
    return {"flops": max(count.flops),
            "bytes_accessed": max(count.bytes_accessed),
            "per_device": {"flops": list(count.flops),
                           "bytes_accessed": list(count.bytes_accessed)}}


def collective_bytes(count) -> dict:
    """Bytes copied between devices in one step, from a ``StepCount``:
    per kind (``models/parallel.py::collective``: ``gather``,
    ``reduce``, ``broadcast``, ``redistribute``, ``all_max``; ``other``
    outside one) with ``total_bytes`` and ``counts`` (copies) as in the
    JAX record, then the bytes each device sends and receives
    (``per_device``) and each (source, destination) pair's
    (``pairs``).  The port's one-process reduce sums the partials on the
    first device, which moves other bytes than a ring all-reduce: these
    are the bytes the port moves."""
    kinds: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    pairs: Dict[str, float] = {}
    sent = [0.0] * len(count.devices)
    received = [0.0] * len(count.devices)
    for (s, d, kind), (nbytes, n) in sorted(count.copies.items()):
        kinds[kind] = kinds.get(kind, 0.0) + nbytes
        counts[kind] = counts.get(kind, 0) + n
        pair = f"{count.devices[s]}->{count.devices[d]}"
        pairs[pair] = pairs.get(pair, 0.0) + nbytes
        sent[s] += nbytes
        received[d] += nbytes
    out = dict(kinds)
    out["total_bytes"] = sum(kinds.values())
    out["counts"] = counts
    out["per_device"] = {"sent": sent, "received": received}
    out["pairs"] = pairs
    return out


_SUGGESTIONS = {
    "compute": ("compute-bound: keep the tensor cores busy: bf16 matmuls "
                "at the tensor cores' shapes, fewer recompute passes, and "
                "causal block skipping in attention to cut masked FLOPs"),
    "memory": ("memory-bound: cut HBM traffic: fuse the elementwise chains "
               "the eager program runs one op at a time, flash the "
               "attention path, reuse each weight over a larger batch, "
               "lower-precision caches and activations"),
    "collective": ("collective-bound: move fewer bytes over NVLink: "
                   "reshard to shrink the cross-card copies, keep the "
                   "data-axis gathers off the critical path and overlap "
                   "them with compute, or reduce-scatter where the port "
                   "sums on one card"),
}


def roofline_report(cfg, shape, mesh, rec: dict) -> dict:
    """The three roofline terms, in seconds, of one dry-run record for
    its busiest device: FLOPs over the peak of the config's compute
    dtype (the tensor cores' bf16 peak, or f32 outside them), bytes
    accessed over the HBM rate, and the most bytes one device sends or
    receives over NVLink's rate a direction; the bottleneck is the
    largest.  ``useful_flop_ratio`` is :func:`model_flops` over the
    counted FLOPs of every device."""
    cost = rec.get("cost", {})
    coll = rec.get("collectives", {})
    peak = (HW.peak_flops_f32 if cfg.compute_dtype == "float32"
            else HW.peak_flops)
    per = coll.get("per_device", {})
    moved = max([0.0, *per.get("sent", ()), *per.get("received", ())])
    compute_s = cost.get("flops", 0.0) / peak
    memory_s = cost.get("bytes_accessed", 0.0) / HW.hbm_bw
    collective_s = moved / HW.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    flops_global = sum(cost.get("per_device", {}).get(
        "flops", [cost.get("flops", 0.0) * mesh.size]))
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "counted_flops_global": flops_global,
        "useful_flop_ratio": (mf / flops_global if flops_global else None),
        "suggestion": _SUGGESTIONS[bottleneck],
    }
