"""The card's peak rates, and the analytic useful-FLOP count.

Port of the JAX package's ``roofline/analysis.py`` without its HLO
parsing (``collective_bytes_from_hlo``, ``extract_cost``,
``roofline_report``): the port runs eagerly and lowers nothing, so there
is no compiled module to read; ``roofline/calculator.py``'s analytic
model is the port's roofline.  :data:`HW` keeps the JAX table's field
names, with the values of an NVIDIA H100 SXM5 (80 GB HBM3, 700 W) in
place of the TPU v5e's.
"""

from __future__ import annotations

import dataclasses


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


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs: 6·N·D train, 2·N·D prefill, 2·N·B decode
    (N = active params for MoE)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens
