"""Blocked, warm-startable top-k eigensolver for the landmark problems.

``topk_eigh`` either factors the m×m operator densely
(``torch.linalg.eigh``) or runs blocked subspace iteration: the W·Q
product in row panels of ``block_rows``, Householder QR
(``torch.linalg.qr``) on the (m, r) panel, and a final Rayleigh–Ritz
rotation.  With ``use_pallas=True`` the panel product is the
hand-written panel-matmul kernel (CUDA on the card).  The iteration
warm-starts from a caller-provided basis ``q0``; a cold start draws its
range from an explicit CPU ``torch.Generator`` and moves it to the
operator's device.

All inputs are symmetric PSD (both W and M are), so the dominant
subspace of the operator itself is the wanted top-k.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops

_EPS = 1e-12
_LINALG_LOADED = False


def load_linalg(device) -> None:
    """Load PyTorch's CUDA linear-algebra library on the calling thread,
    once a process (a no-op off CUDA).

    PyTorch loads that library lazily, at the first CUDA ``torch.linalg``
    call, and the load is not thread-safe: two threads whose first
    ``eigh`` race raise "lazy wrapper should be called at most once".  In
    a fresh process a streaming server's background solve and another
    tenant's inline one do race so.  :class:`~repro_torch.cohort.engine.
    CohortEngine` calls this at construction, before any serving thread
    runs.
    """
    global _LINALG_LOADED
    if _LINALG_LOADED or torch.device(device).type != "cuda":
        return
    torch.linalg.eigh(torch.eye(2, device=device))
    _LINALG_LOADED = True


def _blocked_matmul(w, q, block_rows: int, use_pallas: bool = False):
    """(m, m) @ (m, r) evaluated in row panels of w.

    ``use_pallas=True`` runs the whole panel loop as one launch of the
    panel-matmul kernel (``kernels.ops.panel_matmul``); each entry sums in
    one fixed order, so the result does not depend on the panels.
    """
    m = w.shape[0]
    if block_rows >= m:
        return w @ q
    if use_pallas:
        # QR hands back column-major factors; the kernel reads row-major
        return kernel_ops.panel_matmul(w.contiguous(), q.contiguous())
    return torch.cat([panel @ q for panel in torch.split(w, block_rows)])


def _panel_qr(v):
    """Orthonormal basis of the (m, r) panel's range (Householder QR)."""
    q, _ = torch.linalg.qr(v)
    return q


def subspace_topk(w, r: int, *, iters: int = 30, q0=None, generator=None,
                  block_rows: int = 2048, use_pallas: bool = False):
    """Top-r eigenpairs of symmetric PSD ``w`` via blocked subspace iteration.

    Returns ``(evals, evecs)`` with eigenvalues in DESCENDING order and
    ``evecs`` (m, r) orthonormal Ritz vectors.  ``q0`` (m, r) warm-starts
    the iteration; otherwise the range is drawn from ``generator`` (a CPU
    generator; a fixed seed-0 one when None, so the solver stays
    reproducible).
    """
    m = w.shape[0]
    if q0 is None:
        if generator is None:
            # no caller generator: fall back to a fixed, reproducible range
            # start — the converged Ritz basis is start-agnostic, the
            # constant stream is the point, not a bug
            # repro-lint: ignore[torch-constant-seed]
            generator = torch.Generator().manual_seed(0)
        q0 = torch.randn((m, r), generator=generator, dtype=w.dtype)
    q = _panel_qr(q0.to(device=w.device, dtype=w.dtype))
    for _ in range(iters):
        q = _panel_qr(_blocked_matmul(w, q, block_rows, use_pallas))
    t = q.T @ _blocked_matmul(w, q, block_rows, use_pallas)
    t = 0.5 * (t + t.T)
    evals, u = torch.linalg.eigh(t)                 # ascending
    return evals.flip(0), (q @ u).flip(1)


def topk_eigh(w, r: int, *, solver: str = "eigh", iters: int = 30,
              q0=None, generator=None, block_rows: int = 2048,
              use_pallas: bool = False):
    """Top-r eigenpairs of symmetric PSD ``w``, descending eigenvalues.

    ``solver="eigh"`` — exact dense path (m ≲ 2048).  ``solver=
    "subspace"`` — blocked subspace iteration, the only path that
    warm-starts.
    """
    if solver == "eigh":
        ew, uw = torch.linalg.eigh(w)               # ascending
        return ew.flip(0)[:r], uw.flip(1)[:, :r]
    if solver == "subspace":
        return subspace_topk(w, r, iters=iters, q0=q0, generator=generator,
                             block_rows=block_rows, use_pallas=use_pallas)
    raise ValueError(f"unknown solver {solver!r}")


def isqrt_from_eigs(evals, evecs):
    """Pseudo-inverse square root U Λ^{-1/2} Uᵀ with eigenvalue clipping.

    Eigenvalues below 1e-6·λ_max are treated as zero.
    """
    good = evals > 1e-6 * evals.max()
    inv = torch.where(good, 1.0 / torch.clamp_min(evals, _EPS),
                      torch.zeros_like(evals))
    return (evecs * torch.sqrt(inv)[None, :]) @ evecs.T
