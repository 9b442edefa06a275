"""DQRE-SCnet in PyTorch, with CUDA kernels for Hopper: cohort selection
(Algorithm I + II) and the paper's federated loop.

A port of the JAX package ``repro`` (which stays the reference): the
module tree mirrors it (``repro_torch.cohort.engine`` ports
``repro.cohort.engine`` and so on) and keeps its public names and return
contracts.  Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain PyTorch version.
"""
