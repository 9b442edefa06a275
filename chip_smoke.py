#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Card and build: prints the card's name and power limit, checks that
   float32 matmuls and convolutions are not routed through TF32, and
   builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
   (sm_90a, one nvcc per source, in parallel); prints the registers and
   spills of the redesigned kernels' device functions one by one.
2. Kernels against their plain PyTorch versions, on the card, with the
   error printed beside its limit: the four fused Nyström kernels x
   f32/bf16/int8 at the cohort server's path shape (N=100 000, d=8,
   m=512, k=8) and at a ragged shape; the panel matmul at the subspace
   solver's shapes ((4096, 4096) @ (4096, 64) and @ (4096, 8)); the
   affinity kernels at the fed loop's (100 x 100), the dense path's
   (2048 x 2048) and the unfused Nyström path's (100 000 x 512) shapes;
   each also at a ragged shape, the panel matmul also bit-identical on a
   repeat call and for every block_rows; flash attention (B9) at the
   qwen2-7b prefill's shape (q (1, 2048, 28, 128) against a 2112-row
   cache), at gemma-2b's (q (1, 2048, 8, 256) against one KV head), at
   moonshot-v1-16b-a3b's (16 heads over 16, dh 128), at
   internvl2-26b's (48 heads over 8, dh 128), at deepseek-v3's MLA
   prefill (128 heads, q/k 192, v 128; bf16 and f32) and at
   seamless-m4t-medium's three prefill attentions (B = 4, 16 heads over
   16, dh 64: the encoder, non-causal over 1024 frames, also in f32;
   cross-attention, the 128-token prompt against the 1024 frames; the
   decoder's causal self-attention against a 160-row cache), in bf16 and
   in f32, also non-causal with more keys than queries and more queries
   than keys, and the SSD chunk (B10) at the mamba2-2.7b prefill's (8
   chunks of 256, 80 heads, P=64, N=128) and jamba-v0.1's (128 heads,
   P=64, N=16), each also at ragged shapes (B9's MLA widths with an
   explicit scale).  The bf16 outputs of B9 are held elementwise (see
   LIMIT_BF16_ELEM), the f32 ones to 1e-5 of the largest entry.  The
   cross-affinity (B1), colsum, Gram and extension also at the m=4096
   engine's shape, each timed, bit-identical on a repeat call, B1 also
   timed at int8; the SHA-256 of B1's, the colsum's and the extension's
   output at every case, and of the RBF cross-affinity's (B6) at the
   unfused path's C, a ragged shape and the m=4096 W block, where B6 must
   equal B1 at f32 bit for bit; of the pairwise distances (B7) at the fed
   loop's, the dense path's and a ragged shape, exactly 0 on the diagonal
   and exactly symmetric where x is y; of the square RBF affinity (B8) at
   the dense path's and a ragged shape, where B8(x) must equal B6(x, x)
   with its diagonal set to 0 bit for bit; B7 and B8 at the dense shape
   profiled, which names the kernel they launch
   (``scripts/compare_outputs.py`` compares the outputs themselves with
   another tree's).  Then
   each kernel's median time (CUDA events, 20 runs) at its path shape
   beside its plain version's, the least time the card could take for
   the same work, and one PyTorch call computing the same function where
   there is one; beside it the kernel's own device time (torch.profiler,
   without launch overhead).  B5 and B9 are timed in turns with their
   library call, and their share of the bound and factor to the library
   printed.
3. The cohort server: ``CohortServer(policy="dqn")`` over the fused
   Nyström engine at N=100 000 on the card (method "auto": the mesh
   route, ``cohort/sharded.py``, one shard a visible card), 5 rounds of
   select -> observe -> drift update, with the fused kernels' launch
   counts read afterwards; checks of the result (purity,
   cold-then-warm, the same partition as the CPU solve, bit-identical
   cold re-solve), and one
   select each at bf16 and int8.
4. The paper's federated loop: ``FederatedRunner(policy="dqre_sc",
   use_pallas=True)`` at paper scale (100 clients, 10 a round, 20 local
   steps of batch 32, the 60 000-image synthetic MNIST, eval 2048,
   embed_dim 8, 8 clusters, sigma 0.8), warm-up plus 3 rounds (the last
   under torch.profiler); checks finite losses, 10 distinct ids per
   cohort and one pairwise-distance launch per engine solve.  Then, at a
   small configuration: one dqre_sc round on the card, whose select state
   is handed to a CPU policy, which must give the card engine's partition
   and the same cohort; and one fedavg round on the card and on the CPU,
   printed with the Gumbel pooling noise, and held with decisive noise
   (see ``decisive_pool_noise``) to the same cohort, accuracy within 0.01
   and loss within 1e-3 relative.
5. The other routes of Algorithm I: the engine at m=4096 landmarks
   (the mesh route on the subspace solver, panel-matmul launches 82
   cold / 18 warm, one cross-affinity, colsum, Gram and extension
   launch a select, purity),
   ``spectral_cluster(method="nystrom", use_pallas=True)`` at N=100 000
   (purity), ``spectral_cluster(method="dense", use_pallas=True)`` at
   n=2048 (one pairwise-distance launch, the CPU's partition) and
   ``kernels.ops.rbf_affinity`` at n=2048 (no path calls it).
6. The LM server: ``Server`` with the kernels on, at full width and
   depth in bf16 for qwen2-7b and mamba2-2.7b, 4 slots and 6 requests of
   256-2048 prompt tokens, and for gemma-2b (head_dim 256) 2 requests of
   1024 and 2048 tokens; checks exactly 28 B9 launches (qwen2), 64 B10
   launches (mamba2) and 18 B9 launches (gemma) a prefill, and profiles
   one prefill and one decode step of each.  Then the reduced f32
   configs on the card and on the CPU: the same prefill logits, the same
   greedy tokens, and the card's batch-served tokens equal to its
   batch-1 oracle.
7. Streaming, the frontend and client realism.  (a) A streaming
   ``CohortServer(policy="dqn", state_features="system")`` at the path
   shape, 20 rounds of select -> ``observe_round(outcome=...)`` of a
   ``ClientTrace`` round -> update of the survivors' drifted and the
   joining clients' fresh rows; its solves run on the background
   solver's thread, which makes phase 7's first kernel launch (the
   libraries are unloaded first; the build is phase 1's).  Checks: one
   inline select (the cold start), at least 15 served warm, no failed
   background solve, served versions never going back, the solves'
   grad mode and stream, the last warm result equal bit for bit to a
   second engine's inline replay of the same snapshots, cold purity;
   prints the launches by thread, the select latencies and one profiled
   warm-served select.  (b) ``make_demo_frontend``: 4 tenants of N
   clients (two on one table), with a shared streaming solver (3 waves
   of 16 concurrent selects) and without one (one wave, so the kernels
   launch on the select threads): one solve or adoption per tenant,
   disjoint cohorts in every batch, the pair on one table sharing a
   solve, each tenant's partition equal to a lone server's with the
   seed of the solve it serves.  (c) The paper-scale ``FederatedRunner``
   of phase 4 under a chaos trace and a 3 s deadline, 3 rounds with
   decisive pooling noise: completed + dropped = the cohort, the
   simulated seconds the outcome's, a finite model, B7 every round.

8. (a) The mesh route: ``CohortEngine(method="sharded", mesh=...)``
   at the path shape and at N + 3 rows (padded at every D > 1), fused
   at f32, bf16 and int8, on (cuda:0,) * D for D = 1, 2, 4 (and every
   visible card when there are more than one): D = 1 equal bit for bit
   to the single-device ``"nystrom"`` solve, every D re-solving bit
   for bit, B1 once and B2-B4 D times a solve, the leading k
   eigenvalues within 1e-4 of D = 1's, purity >= 0.95 and D = 1's
   partition.  (b) The MoE server: moonshot-v1-16b-a3b at full width
   and depth in bf16 (phase 6's slots and requests; 48 B9 launches a
   prefill, peak memory, a profiled prefill and decode step split into
   B9, the MoE layers' routing and expert GEMMs, and the host); then
   moonshot, llama4-scout and jamba reduced, card against CPU as in
   phase 6 (jamba: one B9 and one B10 launch a prefill).
9. MLA and prefix embeddings.  (a) deepseek-v3-671b through ``Server``
   at full width in bf16, depth cut to 4 layers (the 3 dense MLA layers
   and the first MoE layer, 256 experts top-8) plus the MTP head, phase
   6's slots and requests: exactly 4 B9 launches a prefill, all at (dh,
   dv) = (192, 128) over 128 heads, peak memory, a profiled prefill and
   decode step.  (b) One full-width MLA block in f32: the expanded
   prefill at S = 2048 (B9 on the card, its plain version on the CPU)
   and one absorbed decode step at position 2048, card against CPU
   within 1e-4 of the largest entry, and the card's absorbed decode
   against its expanded prefill of S + 1 tokens.  (c) internvl2-26b at
   full width and depth in bf16 through ``Server`` on token prompts (48
   B9 launches a prefill at 48 heads over 8), then one ``lm_prefill`` of
   256 prefix embeddings and 1792 tokens (48 B9 launches, finite
   logits, its time).  (d) Both archs reduced, card against CPU as in
   phase 6; internvl2 also with its 4 prefix embeddings.
10. The encoder-decoder, seamless-m4t-medium, through the step
   builders of ``launch/steps.py``.  (a) Full width and depth in bf16
   (12 encoder + 12 decoder layers, 0.877e9 parameters), 4 lockstep
   rows, a source of 1024 frame embeddings drawn from the seed, prompts
   of 128 tokens, 32 greedy decode steps (argmax on the card) against a
   160-row self cache: exactly 36 B9 launches a prefill, all (dh, dv, H,
   K) = (64, 64, 16, 16), 12 in each role (the encoder, non-causal; the
   decoder's causal self-attention; cross-attention, non-causal), none
   in a decode step; peak memory, encode and prefill ms (median of 5),
   decode tok/s, a profiled prefill and decode step, and a repeat
   prefill bit-identical to the first.  (b) Full width in f32, depth cut
   to 2 + 2 layers, one row: prefill and 8 greedy decode steps card
   against CPU within 1e-4 of the largest logit with the same tokens,
   and the card's decode step against teacher forcing (``_decoder`` over
   the prompt and the token) within 1e-4.  (c) Reduced, card against
   CPU: the same through the step builders, and ``Server``, which serves
   the config as a decoder-only LM as the JAX ``Server`` does.

11. LM training through ``launch/steps.py::make_train_step`` with the
   kernels on, which launches none of them: the JAX package's training
   reaches no Pallas kernel, and a call that autograd records takes the
   plain attention and SSD.  (a) gemma-2b and (b) seamless-m4t-medium
   at full width and depth in bf16 with the launcher's optimizer
   (``make_optimizer``: AdamW, f32 moments), global batch 8 x 256 tokens
   from the synthetic token pipeline in 2 microbatches: 6 steps timed
   (host clock ending in a synchronize) and one profiled, split into
   the loss's forward, the clip and the optimizer update; finite losses
   and grad norms, moved parameters, peak memory, no kernel launch.
   (c) Six families reduced in f32 (gemma-2b, mamba2-2.7b,
   moonshot-v1-16b-a3b, deepseek-v3-671b, internvl2-26b,
   seamless-m4t-medium), B 2, S 16, at 1 and 2 microbatches, card
   against CPU: the first loss within 1e-5, every grad norm within
   1e-4 and the loss after 1-3 AdamW steps within 1e-4, relative; then
   on the card a checkpoint of the state before the last step, restored
   bit for bit, whose next step equals the continued run's bit for bit.

12. LM training data-parallel over a mesh of devices
   (``make_train_step(mesh=)`` on trees placed by
   ``models/sharding.py::shard_params``), kernels on and none launched.
   (a) D = 1 on (cuda:0,): reduced f32 gemma-2b and qwen2-7b at 1 and
   2 microbatches, every metric, parameter and moment bit for bit the
   step without a mesh.  (b) D = 2 and 4 on (cuda:0,) * D for reduced
   f32 gemma-2b, qwen2-7b, mamba2-2.7b, internvl2-26b and
   seamless-m4t-medium (B 8, G 2, 3 steps) against D = 1 at phase 11c's
   limits; every replicated leaf identical on all D devices; a
   checkpoint of the sharded state byte-identical to the same state's
   on one device, restored at D = 1 bit for bit.  (c) gemma-2b at full
   width in bf16 over (cuda:0,) * 2 with phase 11a's batch and
   optimizer, 4 steps (the last profiled): its first loss within 1e-3
   of phase 11a's, step ms, tok/s, peak memory, launches.  (d) With four
   visible cards: reduced qwen2-7b over cuda:0-3 as in (b), then
   qwen2-7b at full width in bf16 over the four cards, 7 steps of AdamW
   at 1e-4: a falling loss, step ms, tok/s, each card's peak; with
   fewer cards one line says that (d) was not run.

13. LM training tensor-parallel over a data x model mesh (each
   replica's ``model`` ranks multiply only their slices of the
   projections, ``models/parallel.py``), kernels on and none launched.
   (a) Reduced f32 gemma-2b, qwen2-7b, qwen3-14b, mamba2-2.7b,
   internvl2-26b and seamless-m4t-medium at (data, model) = (1, 2),
   (2, 2) and (1, 4) on (cuda:0,) * n against the card's D = 1 step at
   phase 12b's limits, with its checks of copied leaves and the
   checkpoint.  (b) gemma-2b at full width in bf16 at (1, 2) on
   (cuda:0,) * 2 (its one KV head split mid-head), phase 11a's batch and
   optimizer, 4 steps: its first loss within 1e-3 of phase 11a's, step
   ms, tok/s, peak memory, launches.  (c) With four visible cards:
   reduced qwen3-14b at (1, 4) over cuda:0-3 as in (a), then qwen3-14b
   at full width at (1, 4) and qwen2-7b at (2, 2), bf16, 7 steps of
   AdamW at 1e-4 each: a falling loss, step ms, tok/s, each card's peak
   under its memory; with fewer cards one line says that (c) was not
   run.

14. MoE training over a data x model mesh (global route, expert
   parallelism), kernels on and none launched: (a) the four reduced MoE
   families at (2, 1), (1, 2), (2, 2) on (cuda:0,) * n against the card's
   D = 1 step; (b) with four cards, reduced moonshot at (2, 2), the
   launcher over the cards, moonshot cut to 24 layers at (4, 1) and
   deepseek-v3 cut to 4 at (1, 4) at full width.

15. Serving over a data x model mesh through ``launch/steps.py::
   build_step`` (caches placed by ``models/sharding.py::shard_cache``;
   each rank attends its heads and runs its Mamba heads, B9 and B10 per
   rank in a prefill; a decode step combines the ranks' partial
   softmaxes over their slices of the cache).  (a) Reduced f32
   gemma-2b, qwen2-7b, mamba2-2.7b, internvl2-26b (with its prefix),
   jamba-v0.1, llama4-scout, deepseek-v3 (MLA) and seamless-m4t-medium
   (the encoder-decoder, rows in lockstep) at (data, model) = (1, 2),
   (2, 2) and (1, 4) on (cuda:0,) * n: 4 rows of 16 tokens into a
   64-row cache and 8 greedy decode steps at per-row positions, against
   the card's one-device ``make_prefill_step`` / ``make_decode_step``
   within 1e-4 of the largest logit, the same tokens, B9 and B10
   launched layers x ranks times a prefill and never in a decode step;
   then qwen2-7b, jamba-v0.1 and deepseek-v3 at batch 1 over (2, 2) at
   a long_500k-named shape of 64 rows, window 8: every replica runs the
   row, the caches' sequence cut over (data, model).  (b) With four
   cards: llama4-scout-17b-a16e at (1, 4) and jamba-v0.1-52b at (2, 2)
   at full width and depth in bf16 (neither fits one card; each layer is
   drawn whole on cuda:0, cut and freed), 4 rows of 2048 tokens into a
   4096-row cache: prefill ms (median of 3, ending in a synchronize of
   every card), 32 greedy decode steps' tok/s, a profiled decode step,
   B9 and B10 launches a prefill, each card's peak under its memory;
   then each cut to 8 layers, on the same mesh and whole on cuda:0: how
   far the prefill logits part and how many greedy tokens agree,
   printed (an MoE router's near-ties make bf16 serving chaotic); then
   each in f32 cut to SERVE_4_F32_LAYERS layers, the prefill and 8
   decode steps' logits held within max(1e-4, 10 x the whole model's
   own parting one ulp away) of one card's.  (c) With four cards:
   deepseek-v3 cut to 8 layers (61.14e9 parameters) at (1, 4) and
   seamless-m4t-medium at (2, 2), full width in bf16: the draw's and
   the serving peaks, prefill ms, decode steps, 32 and 144 B9 launches
   a prefill; then deepseek-v3 cut to its 3 dense MLA layers and
   seamless whole in f32, held against one card by (b)'s rule.  (d)
   With four cards: qwen2-7b's batch-1 long_500k decode over (2, 2),
   the 524288-row cache cut over (data, model), its entries drawn from
   the seed: 8 steps from position 266144 (the window spans devices 1
   and 2) and 8 from 524279, fed one card's tokens; bf16 against one
   card printed, an f32 cut of 2 layers held within 1e-4; one bf16
   decode step from 266144 profiled on one card and on the mesh (host
   launches, device busy time, idle share).  With fewer
   cards (b), (c) and (d) each print one line saying they were not run.
   Phase 2 holds B9 at those meshes' per-rank prefill shapes (llama4's
   10 q heads over 2 KV heads, jamba's 16 over 4, deepseek-v3's 32 MLA
   heads, seamless's 8 in its three roles) and B10 at jamba's 64 heads
   a rank.

16. The dry run (``launch/steps.py::lower_step``: the step run once on
   fake tensors on fake devices, counted by ``roofline/counting.py``)
   against the cards, for configurations phases 11-15 run: (a)
   gemma-2b's full-width training step on one card (phase 11a's batch,
   microbatches and optimizer); (b) with four cards, qwen2-7b's
   full-width training step at (data, model) = (2, 2) (phase 13c's), run
   under the dry run's own counter; (c) with four cards,
   llama4-scout-17b-a16e's full-width decode step at (1, 4) over phase
   15b's 4-row, 4096-row cache.  Each card's bytes after placement
   (``torch.cuda.memory_allocated``, less what it held before) held
   within 1 % of the dry run's argument bytes; each training step's peak
   (``max_memory_allocated`` over the one step) within 10 % of the dry
   run's; the bytes (b)'s step copied between cards, by (source,
   destination, kind), equal to the dry run's count; the serving peak
   printed beside its prediction.  No step runs twice.  With one card
   (b) and (c) print one line each saying they were not run.

It prints the kernel table as one JSON line, then the card's name and
power limit, then ``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"

N, D, M, K = 100_000, 8, 512, 8          # the path shape
RAGGED = dict(n=261, m=65, d=7, k=5)     # odd sizes, ~10 % masked rows
RAGGED_GRAM = dict(n=3001, m=640)        # m not a multiple of B3's tile
DTYPES = ("f32", "bf16", "int8")
REPS = 20
PROFILE_TRIES = 3       # profiler sessions a device time may take
SEED = 0          # the table and the kernel inputs
# The engine's seed.  One k-means++ seeding (as in the JAX package) can
# put two of its 8 seeds in one blob and merge two blobs; on this table
# that happens for engine seed 0 (purity 0.874, on the CPU too) and for
# about 4 seedings in 10.  Seed 1 is one of the others.
ENGINE_SEED = 1
# the CPU generator of phase 5's spectral_cluster runs (k-means and
# landmarks)
SPECTRAL_SEED = 0



def _h100_table():
    """The port's H100 table, ``repro_torch/roofline/analysis.py::HW``
    (a module that imports nothing but ``dataclasses``); None outside a
    checkout, where ``main`` refuses to run."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    try:
        from repro_torch.roofline.analysis import HW
    except ImportError:
        return None
    return HW


# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 on the CUDA cores, bf16
# on the tensor cores (dense), HBM3
_HW = _h100_table()
if _HW is not None:
    PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_S = (
        _HW.peak_flops_f32, _HW.peak_flops, _HW.hbm_bw)

# every kernel: the TPU kernel it replaces (function definition in the
# JAX package) and its source
NYSTROM_CU = "src/repro_torch/kernels/csrc/nystrom.cu"
AFFINITY_CU = "src/repro_torch/kernels/csrc/affinity.cu"
FLASH_CU = "src/repro_torch/kernels/csrc/flash_attention.cu"
SSD_CU = "src/repro_torch/kernels/csrc/ssd.cu"
KERNELS = {
    "quantized_cross_affinity": ("src/repro/kernels/nystrom_pallas.py:340",
                                 NYSTROM_CU),
    "nystrom_colsum": ("src/repro/kernels/nystrom_pallas.py:208", NYSTROM_CU),
    "nystrom_gram": ("src/repro/kernels/nystrom_pallas.py:240", NYSTROM_CU),
    "nystrom_extension": ("src/repro/kernels/nystrom_pallas.py:275",
                          NYSTROM_CU),
    "panel_matmul": ("src/repro/kernels/nystrom_pallas.py:311", NYSTROM_CU),
    "rbf_cross_affinity": ("src/repro/kernels/affinity_pallas.py:128",
                           AFFINITY_CU),
    "pairwise_sq_dists": ("src/repro/kernels/affinity_pallas.py:79",
                          AFFINITY_CU),
    "rbf_affinity": ("src/repro/kernels/affinity_pallas.py:103", AFFINITY_CU),
    "flash_attention": ("src/repro/kernels/flash_attention_pallas.py:87",
                        FLASH_CU),
    "ssd_chunk": ("src/repro/kernels/ssd_pallas.py:54", SSD_CU),
}
FUSED = ("quantized_cross_affinity", "nystrom_colsum", "nystrom_gram",
         "nystrom_extension")
# rows of the kernel table beyond one a kernel: {row: kernel}.  B1, B2,
# B3 and B4 at the m=4096 engine's shape (phase 5), timed in phase 2
EXTRA_ROWS = {f"{name}_m4096": name for name in FUSED}
# and B7 at the dense path's n = 2048 (timed in phase 2, launched once by
# phase 5's dense spectral_cluster)
B7_DENSE = "pairwise_sq_dists_dense"
# B1's, B2's and B4's outputs are hashed (SHA-256) at every phase-2 case,
# B6's, B7's and B8's at each of their cases: they must stay bit-identical
# across a redesign (scripts/compare_outputs.py compares the outputs
# themselves)
HASHED = ("quantized_cross_affinity", "nystrom_colsum", "nystrom_extension")
# the device functions of the redesigned kernels (B9's two bodies, B5;
# B3's tile, reduction and rotation kernels, B10; B2's panel kernel, B4's
# packing and row kernels; B1's and B6's one tile kernel), whose registers
# and spills phase 1 prints one by one
REDESIGNED = ("flash_bf16_kernel", "flash_f32_kernel", "panel_kernel",
              "gram_tile_kernel", "gram_reduce_kernel", "rot_tile_kernel",
              "ssd_chunk_kernel", "colsum_partial_kernel",
              "pack_landmarks_kernel", "extension_kernel",
              "cross_tile_kernel")
LIMIT_MAX_REL = 1e-4     # max-abs error over the largest entry
LIMIT_FRO_REL = 1e-5     # gram: relative Frobenius error
# squared distances in the norm form cancel: max-abs error over
# max|x|^2 + max|y|^2
LIMIT_DIST_REL = 1e-5

M_SUBSPACE = 4096        # landmarks that put the engine on the subspace solver
N_DENSE = 2048           # the dense path's largest n (dense_cutoff)
N_LOOP = 100             # the fed loop's clients
# the paper-scale loop of benchmarks/fl_common.py under
# REPRO_BENCH_SCALE=full, with mnist's target
PAPER_FL = dict(dataset="mnist", num_clients=100, clients_per_round=10,
                local_steps=20, batch_size=32, train_size=None,
                eval_size=2048, embed_dim=8, num_clusters=8, sigma=0.8,
                target_accuracy=0.90, policy="dqre_sc", use_pallas=True,
                seed=0)
# the integration test's configuration (tests/test_fed.py)
SMALL_FL = dict(dataset="mnist", num_clients=12, clients_per_round=4,
                local_steps=8, batch_size=16, train_size=1200, eval_size=256,
                num_clusters=3, embed_dim=4, sigma=0.8, policy="dqre_sc",
                use_pallas=True, seed=0)

# the LM server (phase 6): full width and depth, bf16
LM_ARCHS = ("qwen2-7b", "mamba2-2.7b")
# gemma-2b (head_dim 256) served too: 2 requests of these prompt lengths
GEMMA_ARCH, GEMMA_PROMPTS, GEMMA_NEW_TOKENS = "gemma-2b", (1024, 2048), 8
LM_BATCH, LM_REQUESTS, LM_NEW_TOKENS, LM_BUCKET = 4, 6, 32, 8
LM_PROMPT = (256, 2048)          # prompt lengths, drawn from the seed
LM_MAX_SEQ = 2112                # the longest prompt + 32 new tokens, /64
LM_SEED = 0
# B9 and B10 at the prefill's shapes: qwen2 (28 heads over 4, dh 128)
# and mamba2 (80 heads, P 64, N 128, chunks of 256), S = 2048
FLASH_PATH = dict(B=1, S=2048, T=LM_MAX_SEQ, H=28, K=4, dh=128)
# B9 at gemma-2b's prefill: 8 heads over one KV head (MQA), dh 256
FLASH_GEMMA = dict(B=1, S=2048, T=LM_MAX_SEQ, H=8, K=1, dh=256)
SSD_PATH = dict(B=1, c=8, Q=256, H=80, P=64, G=1, N=128)
# B9 at deepseek-v3's MLA prefill (phase 9): its 128 heads expanded over
# this call's own keys, q/k 192 wide (128 + 64 RoPE), v 128, scale
# 1/sqrt(192)
FLASH_MLA = dict(B=1, S=2048, T=2048, H=128, K=128, dh=192, dv=128)
# B9 at internvl2-26b's prefill (phase 9): 48 heads over 8, dh 128
FLASH_INTERNVL = dict(B=1, S=2048, T=LM_MAX_SEQ, H=48, K=8, dh=128)
# A shape no served path reaches (full-width jamba-v0.1, 51.5e9
# parameters, does not fit one card), held and timed in phase 2 with 0
# launches on the paths: B10 at jamba-v0.1's Mamba layer (128 heads of P
# = 64 in one group, N = 16, chunks of 256)
SSD_JAMBA = dict(B=1, c=8, Q=256, H=128, P=64, G=1, N=16)
# B9 at moonshot-v1-16b-a3b's prefill (phase 8b): 16 heads over 16 (MHA)
FLASH_MOONSHOT = dict(B=1, S=2048, T=LM_MAX_SEQ, H=16, K=16, dh=128)
# one rank's prefill under phase 15b's serving meshes: llama4-scout at
# (1, 4) (40/4 q heads over 8/4 KV heads, 4 rows) and jamba-v0.1 at
# (2, 2) (32/2 over 8/2, 2 rows a replica; B10 at 128/2 heads); each rank
# attends its heads over the 2048-token prompt
FLASH_LLAMA4_TP = dict(B=4, S=2048, T=2048, H=10, K=2, dh=128)
FLASH_JAMBA_TP = dict(B=2, S=2048, T=2048, H=16, K=4, dh=128)
SSD_JAMBA_TP = dict(B=2, c=8, Q=256, H=64, P=64, G=1, N=16)
# one rank's prefill under phase 15c's serving meshes.  B9m: deepseek-v3's
# MLA at (1, 4), 128/4 heads expanded over the 4 rows' own keys, q/k 192
# wide, v 128, scale 1/sqrt(192).  B9s: seamless-m4t-medium at (2, 2),
# 16/2 heads and 2 rows a replica, in its three roles: the encoder over
# the 1024 frames (non-causal), the decoder's self-attention over the
# 128-token prompt's own K/V (causal), cross-attention of the prompt
# against the frames (non-causal, Sq != T)
FLASH_MLA_TP = dict(B=4, S=2048, T=2048, H=32, K=32, dh=192, dv=128)
FLASH_SEAMLESS_ENC_TP = dict(B=2, S=1024, T=1024, H=8, K=8, dh=64,
                             causal=False)
FLASH_SEAMLESS_SELF_TP = dict(B=2, S=128, T=128, H=8, K=8, dh=64)
FLASH_SEAMLESS_CROSS_TP = dict(B=2, S=128, T=1024, H=8, K=8, dh=64,
                               causal=False)

# phase 8a: the mesh route at the path shape and at N + 3 rows (padded at
# every D > 1), on (cuda:0,) * D, and on every visible card when there
# are more than one
SHARD_COUNTS = (1, 2, 4)
LIMIT_SHARD_EVALS = 1e-4   # leading k eigenvalues, D against D = 1
# phase 8b: the MoE server, moonshot-v1-16b-a3b at full width and depth
# in bf16 (28.39e9 parameters, 56.8 GB), phase 6's 4 slots and requests;
# then the three MoE archs reduced, card against CPU
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_REDUCED = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
               "jamba-v0.1-52b")
# where a profiled MoE prefill and decode step spend their device time
MOE_GROUPS = {"B9 (flash_attention)": ("kernel", "flash"),
              "MoE layers": ("range", "moe"),
              "  routing (router, top-k, sort)": ("range", "moe.route"),
              "  expert GEMMs": ("range", "moe.experts")}
# phase 9: MLA and prefix embeddings.  (a) deepseek-v3-671b at full
# width in bf16, depth cut to its 3 dense MLA layers and its first MoE
# layer (256 experts top-8, 1 shared, d_ff 2048), with the depth-1 MTP
# head: the 61 layers (671e9 parameters) do not fit one card, and a
# second MoE layer would put the peak near 80 GB.  (b) one full-width MLA
# block in f32, card against CPU: the expanded prefill of MLA_BLOCK_S
# tokens (B9), one absorbed decode step after it, and that step against
# the expanded prefill of MLA_BLOCK_S + 1 tokens.  (c) internvl2-26b at
# full width and depth in bf16 through Server on token prompts, then one
# prefill of VLM_PREFIX prefix embeddings and VLM_TEXT tokens.  (d) both
# archs reduced, card against CPU.
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 4
MLA_BLOCK_S = 2048
VLM_ARCH, VLM_PREFIX, VLM_TEXT = "internvl2-26b", 256, 1792
LIMIT_MLA_REL = 1e-4     # the f32 MLA block: card vs CPU, absorbed vs expanded
# phase 10: the encoder-decoder, seamless-m4t-medium, through the step
# builders.  (a) Full width and depth in bf16 (0.877e9 parameters): 4
# lockstep rows, a source of the config's encoder_seq_len (1024) frames
# drawn from the seed (the stub frontend's frame embeddings), prompts of
# 128 target tokens, 32 greedy decode steps against a 160-row self cache.
# (b) Full width in f32, depth cut to 2 encoder + 2 decoder layers, one
# row, card against CPU.  (c) Reduced, card against CPU: the step
# builders, and Server (the decoder-only route the JAX Server takes).
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_NEW_TOKENS = 4, 128, 32
ENCDEC_SEQ = ENCDEC_PROMPT + ENCDEC_NEW_TOKENS
ENCDEC_CUT_LAYERS, ENCDEC_CUT_STEPS = 2, 8
# (dh, dv, H, K) of every B9 launch of (a)
ENCDEC_FLASH_SHAPE = (64, 64, 16, 16)
# B9 at seamless's three prefill attentions, B = 4: the encoder (S = T
# = 1024 frames, non-causal), cross-attention (the 128-token prompt
# against the frames, non-causal) and the decoder's self-attention (the
# prompt against the 160-row cache, causal)
FLASH_SEAMLESS_ENC = dict(B=4, S=1024, T=1024, H=16, K=16, dh=64,
                          causal=False)
FLASH_SEAMLESS_CROSS = dict(B=4, S=128, T=1024, H=16, K=16, dh=64,
                            causal=False)
FLASH_SEAMLESS_SELF = dict(B=4, S=128, T=160, H=16, K=16, dh=64)
# phase 11: LM training through the port's train step (launch/steps.py),
# with the kernels on: no kernel launches (training takes the plain path,
# as the JAX package's training reaches no Pallas kernel).  (a) gemma-2b
# and (b) seamless-m4t-medium at full width and depth in bf16 with the
# launcher's AdamW (make_optimizer): global batch 8 of 256 tokens from
# the synthetic Markov pipeline, 2 microbatches, 6 steps timed and one
# profiled.  (c) Six families reduced, f32, B 2, S 16, G 1 and 2: card
# against CPU, then a checkpoint round trip on the card.
TRAIN_FULL = ("gemma-2b", "seamless-m4t-medium")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 256, 2, 6
TRAIN_REDUCED = ("gemma-2b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
                 "deepseek-v3-671b", "internvl2-26b", "seamless-m4t-medium")
TRAIN_REDUCED_B, TRAIN_REDUCED_S, TRAIN_REDUCED_STEPS = 2, 16, 4
TRAIN_REDUCED_LR = 1e-3
# card vs CPU from the same parameters (the first step), then the loss
# after 1-3 AdamW steps: past the first update, Adam's m / (sqrt(v) +
# eps) turns last-bit differences of near-zero gradients into different
# signs, so the states part and only the loss trajectory is held (the
# later grad norms are printed)
LIMIT_TRAIN_LOSS_REL = 1e-5      # the first step's loss
LIMIT_TRAIN_GNORM_REL = 1e-4     # the first step's grad_norm
LIMIT_TRAIN_TRAJ_REL = 1e-4      # the loss after 1-3 AdamW steps
# a later grad_norm: within LIMIT_TRAIN_GNORM_REL, or within this many
# times the parting of two CPU runs one ulp apart in every parameter
# (AdamW normalises a near-zero gradient to about ±0.45 lr, so the sign
# that rounding gives it moves the trajectory: PERF.md §7)
TRAIN_ULP_FACTOR = 10
# the profiled step's device time: the loss's forward, the gradient
# clipping and the optimizer update by record_function range (the
# backward runs on autograd's device thread, outside any range), GEMMs by
# kernel name
TRAIN_GROUPS = {"loss forward": ("range", "train.loss"),
                "clip": ("range", "train.clip"),
                "optimizer": ("range", "train.update"),
                "GEMMs": ("kernel", r"gemm|xmma|cutlass|nvjet")}
# phase 12: LM training data-parallel over a mesh of devices
# (make_train_step(mesh=), models/sharding.py), with the kernels on (no
# launches).  (a) D = 1 on (cuda:0,): bit for bit the step without a
# mesh.  (b) D = 2 and 4 on (cuda:0,) * D, reduced f32, against the
# card's D = 1 step at phase 11c's limits.  (c) gemma-2b at full width in
# bf16 over (cuda:0,) * 2, phase 11a's batch.  (d) With four cards:
# reduced qwen2-7b over cuda:0-3 as in (b), then qwen2-7b at full width
# in bf16 over the four cards.
MESH_EXACT = ("gemma-2b", "qwen2-7b")
MESH_REDUCED = ("gemma-2b", "qwen2-7b", "mamba2-2.7b", "internvl2-26b",
                "seamless-m4t-medium")
MESH_COUNTS = (2, 4)
MESH_REDUCED_B, MESH_REDUCED_MICRO, MESH_REDUCED_STEPS = 8, 2, 3
MESH_FULL_ARCH, MESH_FULL_D, MESH_FULL_STEPS = "gemma-2b", 2, 4
MESH_4_ARCH, MESH_4_CARDS, MESH_4_STEPS = "qwen2-7b", 4, 7
# (d) must show the loss falling within its steps: the launcher's warm-up
# (3e-4 * (step + 1) / 200) moves few bf16 weights that early (phase
# 11a: 6.5 % of the probed embedding entries in 7 steps), so (d) takes
# AdamW at a constant rate, f32 moments as the launcher's
MESH_4_LR = 1e-4
# phase 13: LM training tensor-parallel over a data x model mesh, kernels
# on (no launches).  (a) Six reduced families at (data, model) = (1, 2),
# (2, 2), (1, 4) on (cuda:0,) * n against the card's D = 1 step, as
# phase 12b.  (b) gemma-2b at full width in bf16 at (1, 2) on
# (cuda:0,) * 2, phase 11a's batch.  (c) With four cards: reduced
# qwen3-14b at (1, 4) over cuda:0-3 as in (a), then qwen3-14b at (1, 4)
# and qwen2-7b at (2, 2) at full width, AdamW at MESH_4_LR.
TP_REDUCED = ("gemma-2b", "qwen2-7b", "qwen3-14b", "mamba2-2.7b",
              "internvl2-26b", "seamless-m4t-medium")
TP_MESHES = ((1, 2), (2, 2), (1, 4))
TP_FULL_ARCH, TP_FULL_MESH, TP_FULL_STEPS = "gemma-2b", (1, 2), 4
TP_4_REDUCED = ("qwen3-14b", (1, 4))
TP_4_FULL = (("qwen3-14b", (1, 4)), ("qwen2-7b", (2, 2)))
TP_4_STEPS = 7
# phase 14: the MoE families trained over a data x model mesh, kernels on
# (no launches): each MoE layer routes the whole microbatch's tokens
# (capacity, ranks within an expert and aux metrics global) and sends each
# row to the replica that holds its expert (expert parallelism).  (a) The
# four reduced MoE families at (2, 1), (1, 2), (2, 2) on (cuda:0,) * n
# against the card's D = 1 step as 13a, on batches whose microbatches
# hold MOE_MESH_ROWS expanded rows (S = 2048 / k at B 8, G 2) at capacity
# factor MOE_MESH_CAPACITY: the capacity binds over the microbatch
# (C = 2048 of 8192 rows) while one replica's 4096 rows alone would be
# lossless; ``aux`` within LIMIT_AUX_REL.  (b) With four cards: reduced
# moonshot at (2, 2) over cuda:0-3 as (a); the launcher on reduced
# moonshot over the four cards, as a subprocess; then moonshot cut to 24
# layers at (4, 1) (expert parallelism across the cards, a global route
# that drops rows: C = 120) and deepseek-v3 cut to 4 layers at (1, 4)
# (MLA, MoE and MTP tensor-parallel, 32 heads a rank), full width, bf16,
# phase 11a's batch, MOE_4_STEPS steps of AdamW at MESH_4_LR, the first
# loss against a no-grad forward of the whole model on cuda:0.
MOE_MESH_REDUCED = ("deepseek-v3-671b", "jamba-v0.1-52b",
                    "llama4-scout-17b-a16e", "moonshot-v1-16b-a3b")
MOE_MESH_MESHES = ((2, 1), (1, 2), (2, 2))
MOE_MESH_ROWS, MOE_MESH_CAPACITY = 8192, 1.0
LIMIT_AUX_REL = 1e-5     # aux, f32: summation order only
MOE_4_REDUCED = ("moonshot-v1-16b-a3b", (2, 2))
MOE_4_FULL = (("moonshot-v1-16b-a3b", (4, 1), 24),
              ("deepseek-v3-671b", (1, 4), 4))
MOE_4_STEPS = 7
MOE_4_LAUNCHER = ("--arch", "moonshot-v1-16b-a3b", "--reduced", "--steps",
                  "3", "--global-batch", "8", "--seq-len", "128")
MOE_4_LAUNCHER_TIMEOUT_S = 600
# (c)'s first loss against phase 11a's D = 1 loss on the same weights and
# batch: the split changes only the rows each bf16 GEMM sees, hence
# cuBLAS's algorithm and the rounding of bf16 activations (half an ulp,
# 2^-9 relative, each); the loss is an f32 mean over 2048 tokens, which
# averages those roundings, so it is held to about half of one:
LIMIT_MESH_BF16_LOSS_REL = 1e-3
LIMIT_F32_REL = 1e-5     # f32 output: summation order only
# bf16 output, elementwise: |got - want| <= 2^-7 |want| + 1e-3 rms(want).
# Both sides round an f32 result to bf16, so they may differ by one unit
# in the last place, at most 2^-7 of the value; the floor covers entries
# near zero.  A long causal row's output is small (~sqrt(e / s)), so a
# fraction of the largest entry would not hold it.
LIMIT_BF16_ELEM = (2.0 ** -7, 1e-3)
LIMIT_LOGIT_REL = 1e-4   # reduced LM, card vs CPU
# phase 15: serving over a data x model mesh (launch/steps.py::build_step's
# prefill and decode, caches placed by shard_cache), kernels on: B9 per
# rank in every attention layer's prefill, B10 per rank in every Mamba
# layer's.  (a) Six reduced families in f32 at SERVE_MESHES on
# (cuda:0,) * n: a prompt of SERVE_REDUCED_PROMPT tokens, then
# SERVE_REDUCED_STEPS greedy decode steps at per-row positions, against
# the card's one-device make_prefill_step / make_decode_step within
# LIMIT_LOGIT_REL, the same tokens.  (b) With four cards: llama4-scout at
# (1, 4) and jamba-v0.1 at (2, 2) at full width and depth in bf16 (each
# layer drawn whole on cuda:0, cut and freed: neither model fits a card),
# SERVE_4_ROWS rows of SERVE_4_PROMPT tokens into a SERVE_4_CACHE-row
# cache, SERVE_4_STEPS greedy decode steps; then each cut to
# SERVE_4_CUT_LAYERS layers, on the same mesh and whole on cuda:0.
SERVE_REDUCED = ("gemma-2b", "qwen2-7b", "mamba2-2.7b", "internvl2-26b",
                 "jamba-v0.1-52b", "llama4-scout-17b-a16e",
                 "deepseek-v3-671b", "seamless-m4t-medium")
SERVE_MESHES = ((1, 2), (2, 2), (1, 4))
SERVE_REDUCED_B, SERVE_REDUCED_CACHE = 4, 64
SERVE_REDUCED_PROMPT, SERVE_REDUCED_STEPS = 16, 8
# row 0 decodes in rank 0's slice of the sequence at every M; the others
# start past unwritten rows (seamless's 4 rows step in lockstep from the
# prompt's end)
SERVE_REDUCED_POS = (16, 21, 30, 40)
# (a) also serves batch 1 at a long_500k-named shape over (2, 2) on
# (cuda:0,) * 4: every replica runs the row, a KV or latent cache's 64
# rows cut over (data, model) into four slices, a window of 8 for
# qwen2-7b and deepseek-v3 (jamba, a hybrid, decodes unwindowed and
# runs B10 at batch 1); 7 decode steps from position 33, whose window
# (25, 33] spans devices 1 and 2, to 39, whose window lies in device 2's
# slice alone
SERVE_LONG_REDUCED = ("qwen2-7b", "jamba-v0.1-52b", "deepseek-v3-671b")
SERVE_LONG_REDUCED_CACHE, SERVE_LONG_WINDOW = 64, 8
SERVE_LONG_REDUCED_PROMPT, SERVE_LONG_REDUCED_POS = 20, 33
SERVE_LONG_REDUCED_STEPS = 7
SERVE_4 = (("llama4-scout-17b-a16e", (1, 4)), ("jamba-v0.1-52b", (2, 2)))
SERVE_4_ROWS, SERVE_4_PROMPT, SERVE_4_CACHE, SERVE_4_STEPS = 4, 2048, 4096, 32
SERVE_4_PREFILLS = 3
SERVE_4_CUT_LAYERS = 8
# (b)'s depth cut in bf16, mesh against one card: the prefill logits'
# parting over the largest |logit| and the greedy tokens that agree are
# printed, not held.  Tensor parallelism moves where bf16 rounds (a
# row-parallel projection sums M partials rounded to bf16 where one card
# rounds once; split GEMMs take other tile orders), and a moved rounding
# flips an MoE router's near-tie, which moves a token by its whole FFN
# output: on NVIDIA H100 80GB HBM3 at 700 W one ulp in every weight moved
# the whole 8-layer cut's logits 1.219 (llama4) and 0.170 (jamba) of
# their largest, so no bf16 limit would bound the mesh's arithmetic.  It
# is held at full width in f32, where a rounding moves a route only at a
# near-tie of ~1e-7: each arch cut to SERVE_4_F32_LAYERS layers (llama4:
# 2 MoE layers; jamba: 4 Mamba, its first attention layer, 2 MoE) fits
# cuda:0 whole in f32, and the mesh's prefill and SERVE_REDUCED_STEPS
# decode steps (fed the one-card run's greedy tokens) are held within
# LIMIT_LOGIT_REL.  Such near-ties do occur: at jamba's draw one token
# of 8192 has its 2nd and 3rd router probabilities one f32 ulp apart
# (1.192e-7), the mesh and a run one ulp away both send it to another
# expert, and both part 1.1e-4 (scripts/serve_mesh_parting.py).  So, as
# in phase 11c, the limit is max(LIMIT_LOGIT_REL, SERVE_ULP_FACTOR x the
# parting of the whole model one ulp away): the floor holds where no
# route sits at a tie (the mesh then parts 4e-6-6e-6), and a bug in the
# mesh's arithmetic parts far beyond either.
SERVE_ULP_FACTOR = TRAIN_ULP_FACTOR
SERVE_4_F32_LAYERS = {"llama4-scout-17b-a16e": 2, "jamba-v0.1-52b": 5,
                      "deepseek-v3-671b": 3}
# (c) With four cards: MLA and the encoder-decoder.  deepseek-v3 at
# (1, 4), full width in bf16, depth cut to its 3 dense MLA layers and 5
# MoE layers with the MTP head (each MoE layer drawn whole on cuda:0:
# 23 GB in bf16 beside its largest expert tensor in f32, 15 GB), phase
# (b)'s 4 rows of 2048 tokens; seamless-m4t-medium at (2, 2) at full
# width and depth in bf16, phase 10's batch (4 rows, 1024 frames, a
# 128-token prompt, 32 steps).  Then each in f32 against one card by
# (b)'s rule: deepseek-v3 cut to its 3 dense MLA layers
# (SERVE_4_F32_LAYERS), seamless whole.
SERVE_4C = (("deepseek-v3-671b", (1, 4), 8),
            ("seamless-m4t-medium", (2, 2), None))
# (d) With four cards: qwen2-7b's long_500k decode, batch 1 over (2, 2):
# the 524288-row cache (30.1 GB in bf16) cut over (data, model) into
# four slices of 131072 rows, its entries drawn from the seed (a
# prefill of 524288 tokens is not run); LONG_STEPS decode steps from
# each of LONG_STARTS: from 266144, whose 8192-row window spans devices
# 1 and 2, and from 524279, the cache's last rows.  bf16 at full width
# and depth against the same decode whole on cuda:0 (45 GB), printed;
# an f32 cut of LONG_F32_LAYERS layers held within LIMIT_LOGIT_REL; the
# mesh is fed one card's greedy tokens.  The bf16 run profiles one step
# from LONG_STARTS[0] on one card and on the mesh, after the timed steps
LONG_ARCH, LONG_SHAPE = "qwen2-7b", "long_500k"
LONG_STARTS, LONG_STEPS, LONG_F32_LAYERS = (266_144, 524_279), 8, 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def blobs(rng, n=N, d=D, k=K):
    """8 well-separated blobs, generated as the serve CLI's demo does."""
    import numpy as np
    centers = rng.normal(size=(k, d)).astype(np.float32) * 6
    labels = rng.integers(0, k, n)
    x = centers[labels] + rng.normal(size=(n, d)).astype(np.float32)
    return x, labels


def time_ms(fn, reps=REPS) -> float:
    """Median wall time of ``fn`` on the card, CUDA events per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=REPS):
    """Mean device time of one call: the kernels' own time from
    torch.profiler, without the host's launch overhead that CUDA events
    around a small call include.  Now and then a profiler session comes
    back without the device's records; such a session is run again, up to
    PROFILE_TRIES times, and None (not measured) is returned if none saw
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    print(f"device time not measured: {PROFILE_TRIES} profiler sessions "
          f"saw no device records", file=sys.stderr)
    return None


def ms_text(ms):
    """A device time for a printed line: "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def vs_library(kern, library):
    """A kernel and the library call that computes its function, timed in
    turns on the same inputs: CUDA events (kernel, library, library,
    kernel; each the median of REPS calls), then each one's device time
    from torch.profiler.  Returns (ms, library ms, device ms, library
    device ms), the event times the mean of each one's two turns."""
    k1, l1, l2, k2 = (time_ms(kern), time_ms(library), time_ms(library),
                      time_ms(kern))
    return (k1 + k2) / 2, (l1 + l2) / 2, device_ms(kern), device_ms(library)


def print_vs_library(name, label, times, bound_ms, bound_by):
    ms, lib_ms, dev, lib_dev = times
    shares = ("" if dev is None or lib_dev is None else
              f": {bound_ms / dev:.4f} of the bound, {dev / lib_dev:.3f}x "
              f"the library's device time")
    print(f"phase 2: {name:25s} {label:9s} device {ms_text(dev)}, library "
          f"{ms_text(lib_dev)} (events {ms:.4f} and {lib_ms:.4f} ms, in "
          f"turns); bound {bound_ms:.5f} ms by {bound_by}{shares}")


# -- phase 1 ----------------------------------------------------------------

def phase1():
    import torch
    from repro_torch.kernels import _build

    print("phase 1: card", card_line())
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: the f32 path must be exact")
    # cuDNN runs f32 convolutions in TF32 unless told not to
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 convolutions are on")
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_DIR.name}, sources hash {_build.source_hash()})")
    log = _build.LIBRARY.build_log
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
    if regs:
        print(f"phase 1: ptxas: {len(regs)} kernels, at most {max(regs)} "
              f"registers a thread, {spills} bytes of spill stores + loads")
    for kernel, nregs, stores, loads in ptxas_kernels(log, REDESIGNED):
        print(f"phase 1: ptxas: {kernel:38s} {nregs:3d} registers, spill "
              f"stores {stores} B, loads {loads} B")


def ptxas_kernels(log, names):
    """[(kernel<template args>, registers, spill store bytes, spill load
    bytes)] of the kernels in nvcc's ``-Xptxas -v`` log whose name is one
    of ``names``."""
    rows = []
    arg = r"f|\d+__nv_bfloat16|L[a-z]+\d+E"   # float, bf16, an integer
    for block in log.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        m = re.search(r"\d(" + "|".join(names) + rf")(?:I((?:{arg})+)E)?",
                      mangled)
        used = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if m is None or used is None:
            continue
        args = ",".join(
            "bf16" if "bfloat16" in a else "f32" if a == "f" else
            re.sub(r"L[a-z]+(\d+)E", r"\1", a)
            for a in re.findall(arg, m.group(2) or ""))
        rows.append((f"{m.group(1)}<{args}>", int(used.group(1)),
                     int(spill.group(1)) if spill else 0,
                     int(spill.group(2)) if spill else 0))
    return rows


# -- phase 2 ----------------------------------------------------------------

def _inputs(rng, n, m, d, k, *, x=None, gamma=None):
    """Kernel inputs on the card, fixture style (test_fused_nystrom)."""
    import numpy as np
    import torch
    dev = "cuda"
    if x is None:
        x = rng.normal(size=(n, d)).astype(np.float32)
    z = x[rng.choice(n, m, replace=False)]
    t = dict(
        x=torch.tensor(x, device=dev), z=torch.tensor(z, device=dev),
        gamma=0.37 if gamma is None else gamma,
        mask=torch.tensor((rng.random(n) > 0.1).astype(np.float32),
                          device=dev),
        u=torch.tensor(rng.normal(size=(m,)) ** 2 + 0.1, dtype=torch.float32,
                       device=dev),
        wis=torch.tensor(rng.normal(size=(m, m)) / np.sqrt(m),
                         dtype=torch.float32, device=dev),
        proj=torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32,
                          device=dev))
    return t


def _calls(t, dtype, mask):
    """(kernel call, plain call) per kernel on inputs ``t``."""
    from repro_torch.kernels import nystrom as kn
    from repro_torch.kernels import ref
    x, z, g, u, wis, proj = (t["x"], t["z"], t["gamma"], t["u"], t["wis"],
                             t["proj"])
    kw = dict(affinity_dtype=dtype)
    return {
        "quantized_cross_affinity": (
            lambda: kn.quantized_cross_affinity(z, z, g, **kw),
            lambda: ref.quantized_cross_affinity_ref(z, z, g, **kw)),
        "nystrom_colsum": (
            lambda: kn.nystrom_colsum(x, z, g, mask, **kw),
            lambda: ref.nystrom_colsum_ref(x, z, g, mask, **kw)),
        "nystrom_gram": (
            lambda: kn.nystrom_gram(x, z, g, u, wis, mask, **kw),
            lambda: ref.nystrom_gram_ref(x, z, g, u, wis, mask, **kw)),
        "nystrom_extension": (
            lambda: kn.nystrom_extension(x, z, g, u, proj, mask, **kw),
            lambda: ref.nystrom_extension_ref(x, z, g, u, proj, mask, **kw)),
    }


def _error(name, got, want):
    """(error, limit, max-abs error) of a kernel output vs its plain one."""
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    max_abs = float(diff.max())
    if name == "nystrom_gram":
        err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        return err, LIMIT_FRO_REL, max_abs
    return max_abs / float(want.abs().max()), LIMIT_MAX_REL, max_abs


def _bound(name, n, m, d, k):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the f32 operations over the f32 peak, for one call's work.

    An affinity entry costs 2d + 5 operations (the d-term dot as FMAs,
    the norm sum, the clamp, the gamma scale and one exp); the point
    norms and int8 scales are O((n + m) d) and left out.  SᵀS is
    symmetric, so the Gram counts its upper triangle with the diagonal,
    n·m·(m + 1) operations, not 2·n·m²; the rotation W⁻¹ᐟ²·G·W⁻¹ᐟ² is
    two general (m, m) products, 4m³.
    """
    entry = 2 * d + 5
    if name == "quantized_cross_affinity":      # (m, m) block W = A(z, z)
        ops = m * m * entry
        nbytes = 4 * (2 * m * d + m * m)
    elif name == "nystrom_colsum":
        ops = n * m * (entry + 1)
        nbytes = 4 * (n * d + m * d + m)
    elif name == "nystrom_gram":   # C once, C.u, the half of S^T S, rotation
        ops = n * m * (entry + 3) + n * m * (m + 1) + 4 * m ** 3
        nbytes = 4 * (n * d + m * d + m + 2 * m * m)
    else:                                       # C once, C.u, S.proj, norm
        ops = n * m * (entry + 3 + 2 * k) + 3 * n * k
        nbytes = 4 * (n * d + m * d + m + m * k + n * k)
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase2_inputs(x_path, gamma_path):
    """Phase 2's inputs of the four fused kernels: {shape: tensors}."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    return {
        "path": _inputs(rng, N, M, D, K, x=x_path, gamma=gamma_path),
        "ragged": _inputs(rng, RAGGED["n"], RAGGED["m"], RAGGED["d"],
                          RAGGED["k"]),
        # B3's 128-wide tiles with a partial last one
        "m640": _inputs(rng, RAGGED_GRAM["n"], RAGGED_GRAM["m"], D, K),
    }


def m4096_inputs(x_path, gamma_path):
    """(rng, inputs) of the m=4096 engine's shape, for phase 2."""
    import numpy as np
    rng = np.random.default_rng(SEED + 6)
    return rng, _inputs(rng, N, M_SUBSPACE, D, K, x=x_path, gamma=gamma_path)


def print_hash(name, case, t):
    """Prints the SHA-256 of a kernel output."""
    digest = hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
    print(f"phase 2: sha256 {name} {case}: {digest}")


def phase2(x_path, gamma_path):
    """Every kernel x dtype vs its plain version; times at the path shape.

    Returns {name: record} for the JSON kernel table.
    """
    import torch
    shapes = phase2_inputs(x_path, gamma_path)
    records = {name: {"name": name, "route": "cuda", "source": KERNELS[name][1],
                      "replaces": KERNELS[name][0]} for name in FUSED}
    for shape, t in shapes.items():
        for dtype in DTYPES:
            for name, (kern, plain) in _calls(t, dtype, t["mask"]).items():
                got = kern()
                err, limit, max_abs = _error(name, got, plain())
                ok = err <= limit
                print(f"phase 2: {name:25s} {shape:6s} {dtype:4s} "
                      f"err {err:.3e} (limit {limit:.0e}) "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"{name} {shape} {dtype}: error {err:.3e} > "
                        f"{limit:.0e}")
                if name in ("nystrom_gram", *HASHED) and \
                        not torch.equal(kern(), got):
                    raise AssertionError(f"{name} {shape} {dtype}: a "
                                         f"repeat call differs")
                if name in HASHED:
                    print_hash(name, f"{shape} {dtype}", got)
                if shape == "path" and dtype == "f32":
                    records[name]["max_abs_err"] = max_abs
    # time the main path's call: f32, no mask
    t = shapes["path"]
    for name, (kern, plain) in _calls(t, "f32", None).items():
        err, limit, max_abs = _error(name, kern(), plain())
        if err > limit:
            raise AssertionError(f"{name} path f32 unmasked: error "
                                 f"{err:.3e} > {limit:.0e}")
        rec = records[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
        rec["ms"] = time_ms(kern)
        rec["plain_ms"] = time_ms(plain)
        rec["bound_ms"], rec["bound_by"] = _bound(name, N, M, D, K)
        # no single PyTorch call computes any of these four functions
        rec["library_ms"] = None
        print(f"phase 2: {name:25s} {rec['ms']:.4f} ms (device "
              f"{ms_text(device_ms(kern))}; plain {rec['plain_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']})")
    return records


def _bound_of(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bound_slice2(name, shape):
    """(bound_ms, bound_by) of one call of a slice-2 kernel at ``shape``.

    Each input read once, each output written once; operations: a
    multiply-add counts 2, an affinity entry 2d + 5 (as in ``_bound``),
    a difference-form squared distance 3d + 1.
    """
    if name == "panel_matmul":
        m, p, r = shape
        return _bound_of(2 * m * p * r, 4 * (m * p + p * r + m * r))
    n, m, d = shape
    nbytes = 4 * (n * d + m * d + n * m) if name != "rbf_affinity" else \
        4 * (n * d + n * m)
    per_entry = 3 * d + 1 if name == "pairwise_sq_dists" else 2 * d + 5
    return _bound_of(n * m * per_entry, nbytes)


def slice2_inputs(x_path):
    """The inputs of B5–B8 in phase 2, on the card: {name: tensor}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 3)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device="cuda")

    x_big = t(x_path)
    z = t(x_path[rng.choice(len(x_path), M, replace=False)])
    dense = t(x_path[:N_DENSE])
    loop = t(rng.normal(size=(N_LOOP, D)) * 0.01)     # embedding-sized
    rx, ry = t(rng.normal(size=(37, 7))), t(rng.normal(size=(21, 7)))
    zs = t(x_path[rng.choice(len(x_path), M_SUBSPACE, replace=False)])
    q64 = t(rng.normal(size=(M_SUBSPACE, 64)))
    q8 = t(rng.normal(size=(M_SUBSPACE, K)))
    rw, rq = t(rng.normal(size=(130, 70))), t(rng.normal(size=(70, 9)))
    return dict(x_big=x_big, z=z, dense=dense, loop=loop, rx=rx, ry=ry,
                zs=zs, q64=q64, q8=q8, rw=rw, rq=rq)


def cross_cases(inputs):
    """B6's phase-2 cases, {label: (shape, x, y)}: the unfused Nyström
    path's C, a ragged shape and the m=4096 engine's W block."""
    i = inputs
    return {"path": ((N, M, D), i["x_big"], i["z"]),
            "ragged": ((37, 21, 7), i["rx"], i["ry"]),
            "W": ((M_SUBSPACE, M_SUBSPACE, D), i["zs"], i["zs"])}


def dist_cases(inputs):
    """B7's phase-2 cases, {label: (shape, x, y)}: the fed loop's 100
    embeddings, the dense path's n = 2048 and a ragged shape."""
    i = inputs
    return {"loop": ((N_LOOP, N_LOOP, D), i["loop"], i["loop"]),
            "dense": ((N_DENSE, N_DENSE, D), i["dense"], i["dense"]),
            "ragged": ((37, 21, 7), i["rx"], i["ry"])}


def square_cases(inputs):
    """B8's phase-2 cases, {label: (shape, x)}: the dense path's n = 2048
    and a ragged n."""
    i = inputs
    return {"dense": ((N_DENSE, N_DENSE, D), i["dense"]),
            "ragged": ((37, 37, 7), i["rx"])}


def _slice2_calls(x_path, gamma_path):
    """{kernel: [(label, shape, kernel call, plain call, error, library
    call)]}: every path shape first, then a ragged one."""
    import torch
    from repro_torch.kernels import ops, ref

    def dist_err(got, want, x, y):
        scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
        return float((got - want).abs().max()) / scale, LIMIT_DIST_REL

    def rel_err(got, want, *_):
        return float((got - want).abs().max() / want.abs().max()), \
            LIMIT_MAX_REL

    inputs = slice2_inputs(x_path)
    zs, q64, q8, rw, rq = (inputs[k] for k in ("zs", "q64", "q8", "rw",
                                               "rq"))
    w_op = ref.rbf_cross_affinity_ref(zs, zs, gamma_path)   # W at m=4096
    g = gamma_path

    # (kernel call, plain call, error, library call): torch.matmul (TF32
    # off) is the one PyTorch call that computes the panel product; no
    # single call computes the other three.  ``kern.operands``: for the
    # bit checks
    def dist(a, b):
        def kern():
            return ops.pairwise_sq_dists(a, b)
        kern.operands = (a, b)
        return (kern, lambda: ref.pairwise_sq_dists_ref(a, b),
                lambda got, want: dist_err(got, want, a, b), None)

    def cross(a, b):
        def kern():
            return ops.rbf_cross_affinity(a, b, g)
        kern.operands = (a, b, g)
        return (kern, lambda: ref.rbf_cross_affinity_ref(a, b, g), rel_err,
                None)

    def square(a):
        def kern():
            return ops.rbf_affinity(a, g)
        kern.operands = (a, g)
        return (kern, lambda: ref.rbf_affinity_ref(a, g), rel_err, None)

    def panel(w, q):
        def kern():
            return ops.panel_matmul(w, q)
        kern.operands = (w, q)     # for the determinism checks
        return (kern, lambda: ref.panel_matmul_ref(w, q), rel_err,
                lambda: torch.matmul(w, q))

    return {
        "panel_matmul": [
            ("W", (M_SUBSPACE, M_SUBSPACE, 64), *panel(w_op, q64)),
            ("M", (M_SUBSPACE, M_SUBSPACE, K), *panel(w_op, q8)),
            ("ragged", (130, 70, 9), *panel(rw, rq))],
        "rbf_cross_affinity": [
            (label, shape, *cross(a, b))
            for label, (shape, a, b) in cross_cases(inputs).items()],
        "pairwise_sq_dists": [
            (label, shape, *dist(a, b))
            for label, (shape, a, b) in dist_cases(inputs).items()],
        "rbf_affinity": [
            (label, shape, *square(a))
            for label, (shape, a) in square_cases(inputs).items()],
    }


def phase2_m4096(x_path, gamma_path):
    """B1–B4 at the m=4096 engine's shape (N=10⁵, d=8, m=4096, k=8, f32,
    no mask; B1 builds the (m, m) block W): each held to its plain
    version, bit-identical on a repeat call, timed, and its device time
    split by kernel (torch.profiler).  B1 also at int8, timed on a
    printed line; B3 also bit-identical at m=2048 (masked).  Returns
    their records."""
    import torch

    rng, t = m4096_inputs(x_path, gamma_path)
    calls = _calls(t, "f32", None)
    records = {}
    for row, name in EXTRA_ROWS.items():
        kern, plain = calls[name]
        got = kern()
        err, limit, max_abs = _error(name, got, plain())
        print(f"phase 2: {row:25s} m={M_SUBSPACE} f32 err {err:.3e} "
              f"(limit {limit:.0e}) {'ok' if err <= limit else 'FAIL'}")
        if err > limit:
            raise AssertionError(f"{row}: error {err:.3e} > {limit:.0e}")
        if not torch.equal(kern(), got):
            raise AssertionError(f"{row}: a repeat call differs")
        if name in HASHED:
            print_hash(name, f"m{M_SUBSPACE} f32", got)
        rec = records[row] = {
            "name": row, "route": "cuda", "source": KERNELS[name][1],
            "replaces": KERNELS[name][0], "max_abs_err": max_abs,
            "ms": time_ms(kern, reps=5), "plain_ms": time_ms(plain, reps=5),
            "library_ms": None}
        rec["bound_ms"], rec["bound_by"] = _bound(name, N, M_SUBSPACE, D, K)
        print(f"phase 2: {row:25s} {rec['ms']:.4f} ms (device "
              f"{ms_text(device_ms(kern, reps=5))}; plain {rec['plain_ms']:.4f} "
              f"ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}); "
              f"a repeat call bit-identical")
        profile_device(2, f"{row} (one call)", kern)
    # B1 at int8: the engine's int8 selects build W this way
    kern, plain = _calls(t, "int8", None)["quantized_cross_affinity"]
    err, limit, _ = _error("quantized_cross_affinity", kern(), plain())
    if err > limit:
        raise AssertionError(f"quantized_cross_affinity m={M_SUBSPACE} int8: "
                             f"error {err:.3e} > {limit:.0e}")
    print(f"phase 2: {'quantized_cross_affinity':25s} m={M_SUBSPACE} int8 "
          f"err {err:.3e}: {time_ms(kern, reps=5):.4f} ms (device "
          f"{ms_text(device_ms(kern, reps=5))})")
    # and B3 at m=2048, masked
    t2 = _inputs(rng, N, 2048, D, K, x=x_path, gamma=gamma_path)
    k2048 = _calls(t2, "f32", t2["mask"])["nystrom_gram"][0]
    if not torch.equal(k2048(), k2048()):
        raise AssertionError("nystrom_gram m=2048: a repeat call differs")
    print("phase 2: nystrom_gram m=2048 masked: a repeat call bit-identical")
    return records


def phase2_slice2(x_path, gamma_path):
    """B5–B8 against their plain versions, then timed at the path shapes.

    The JSON row of each kernel is timed at its first (path) shape: the
    subspace solver's W product for the panel matmul, the fed loop's
    100 x 100 for the pairwise distances; the other path shapes are
    printed beside it, and the pairwise distances at the dense path's
    2048 x 2048 also make a row of their own (``B7_DENSE``).  Returns
    {name: record}.
    """
    import torch

    records = {}
    for name, cases in _slice2_calls(x_path, gamma_path).items():
        rec = records[name] = {"name": name, "route": "cuda",
                               "source": KERNELS[name][1],
                               "replaces": KERNELS[name][0],
                               "max_abs_err": 0.0}
        for i, (label, shape, kern, plain, error, library) in enumerate(
                cases):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or got.shape != want.shape:
                raise AssertionError(f"{name} {label}: malformed output")
            err, limit = error(got, want)
            ok = err <= limit
            print(f"phase 2: {name:25s} {label:6s} {shape} err {err:.3e} "
                  f"(limit {limit:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {label}: error {err:.3e} > "
                                     f"{limit:.0e}")
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     float((got - want).abs().max()))
            if name == "panel_matmul":
                _panel_determinism(label, kern, got)
            if name == "rbf_cross_affinity":
                _cross_bits(label, kern, got)
            if name == "pairwise_sq_dists":
                _dist_bits(label, kern, got)
            if name == "rbf_affinity":
                _square_bits(label, kern, got)
            if label == "ragged":
                continue
            ms, plain_ms = time_ms(kern), time_ms(plain)
            bound_ms, bound_by = _bound_slice2(name, shape)
            library_ms = None
            if library is not None:
                times = vs_library(kern, library)
                ms, library_ms = times[:2]
                print_vs_library(name, label, times, bound_ms, bound_by)
            print(f"phase 2: {name:25s} {label:6s} {ms:.4f} ms (device "
                  f"{ms_text(device_ms(kern))}; plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
                  f"{bound_by}, library "
                  f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'})")
            timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
            if i == 0:
                rec.update(timed)
            if name in ("pairwise_sq_dists", "rbf_affinity") and \
                    label == "dense":
                # which kernel the wrapper launches, by name
                profile_device(2, f"{name} {label} (one call)", kern)
            if name == "pairwise_sq_dists" and label == "dense":
                records[B7_DENSE] = {
                    **rec, "name": B7_DENSE,
                    "max_abs_err": float((got - want).abs().max()), **timed}
    return records


def _cross_bits(label, kern, got):
    """B6's contract: a repeat call is bit-identical, and so is B1 at f32
    on the same operands (the JAX docstring's "reproduces exactly");
    prints B6's SHA-256."""
    import torch
    from repro_torch.kernels import nystrom as kn

    if not torch.equal(kern(), got):
        raise AssertionError(f"rbf_cross_affinity {label}: a repeat call "
                             f"differs")
    print_hash("rbf_cross_affinity", f"{label} f32", got)
    if not torch.equal(kn.quantized_cross_affinity(*kern.operands), got):
        raise AssertionError(f"rbf_cross_affinity {label}: "
                             f"quantized_cross_affinity at f32 differs")
    print(f"phase 2: {'rbf_cross_affinity':25s} {label:6s} repeat call and "
          f"quantized_cross_affinity f32: bit-identical")


def _dist_bits(label, kern, got):
    """B7's contract: a repeat call is bit-identical; on a square case
    (x is y) the diagonal is exactly 0 and the output exactly symmetric
    (the difference form); prints B7's SHA-256."""
    import torch

    if not torch.equal(kern(), got):
        raise AssertionError(f"pairwise_sq_dists {label}: a repeat call "
                             f"differs")
    print_hash("pairwise_sq_dists", f"{label} f32", got)
    x, y = kern.operands
    square = x is y
    if square and not (torch.all(got.diagonal() == 0)
                       and torch.equal(got, got.T)):
        raise AssertionError(f"pairwise_sq_dists {label}: diagonal not 0 "
                             f"or not symmetric")
    print(f"phase 2: {'pairwise_sq_dists':25s} {label:6s} repeat call "
          f"bit-identical" + ("; diagonal exactly 0, exactly symmetric"
                              if square else ""))


def _square_bits(label, kern, got):
    """B8's contract: a repeat call is bit-identical, and B8(x) is B6(x, x)
    with its diagonal set to 0, bit for bit; prints B8's SHA-256."""
    import torch
    from repro_torch.kernels import ops

    if not torch.equal(kern(), got):
        raise AssertionError(f"rbf_affinity {label}: a repeat call differs")
    print_hash("rbf_affinity", f"{label} f32", got)
    x, g = kern.operands
    cross = ops.rbf_cross_affinity(x, x, g).fill_diagonal_(0.0)
    if not torch.equal(got, cross):
        raise AssertionError(f"rbf_affinity {label}: differs from "
                             f"rbf_cross_affinity(x, x) off the diagonal")
    print(f"phase 2: {'rbf_affinity':25s} {label:6s} repeat call and "
          f"rbf_cross_affinity(x, x) with a zero diagonal: bit-identical")


def _panel_determinism(label, kern, got):
    """B5's contract: a repeat call is bit-identical, and the subspace
    solver's product is the same for every block_rows."""
    import torch
    from repro_torch.cohort.eigensolver import _blocked_matmul

    w, q = kern.operands
    if not torch.equal(kern(), got):
        raise AssertionError(f"panel_matmul {label}: a repeat call differs")
    rows = [br for br in (16, 256, 2048) if br < w.shape[0]]
    for br in rows:
        if not torch.equal(_blocked_matmul(w, q, br, use_pallas=True), got):
            raise AssertionError(f"panel_matmul {label}: block_rows={br} "
                                 f"gives another product")
    print(f"phase 2: {'panel_matmul':25s} {label:6s} repeat call and "
          f"block_rows {rows}: bit-identical")


# -- phase 3 ----------------------------------------------------------------

def purity(assign, labels):
    import numpy as np
    return sum(np.bincount(labels[assign == c]).max()
               for c in np.unique(assign)) / len(labels)


def same_partition(a, b):
    pairs = {(int(x), int(y)) for x, y in zip(a, b)}
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@contextlib.contextmanager
def plain_on_card_forbidden():
    """Every plain kernel version raises on CUDA tensors inside the block:
    the path must go through the kernels."""
    from repro_torch.kernels import ref

    def guard(fn):
        def wrapped(x, *args, **kwargs):
            if x.is_cuda:
                raise AssertionError(f"{fn.__name__} ran on the card")
            return fn(x, *args, **kwargs)
        return wrapped

    saved = {f"{name}_ref": getattr(ref, f"{name}_ref") for name in KERNELS}
    for name, fn in saved.items():
        setattr(ref, name, guard(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def profile_device(phase, what, fn, host_top=0, groups=None):
    """Run ``fn()`` once under torch.profiler; prints the wall time, the
    device's busy time and idle share and the top device operations (and,
    with ``host_top``, the operators with the most host time and the
    count of kernel launches).  ``groups`` ({label: ("kernel", pattern)
    or ("range", name)}) also splits the busy time: the device time of
    the kernels whose name matches ``pattern``, or of every kernel
    launched inside the ``record_function`` range ``name``; wall - busy
    is the host's.  Returns (fn's result, wall ms, busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): an operator's own row
    # repeats the device time of the kernels it launched, and a range's
    # device row spans its kernels and the gaps between them
    ranges = {name for kind, name in (groups or {}).values()
              if kind == "range"}
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"phase {phase}: profiled {what}: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms"
          + (f" (idle share {1 - busy / wall:.4f})" if busy
             else " (device time not measured)"))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"phase {phase}:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")
    if groups:
        # a range's kernels: the device time its host-side row collects
        launched = {e.key: e.device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CPU}
        split = {}
        for label, (kind, name) in groups.items():
            split[label] = (sum(e.self_device_time_total for e in events
                                if re.search(name, e.key))
                            if kind == "kernel" else launched.get(name, 0.0)
                            ) / 1e3
        split["host (wall - busy)"] = wall - busy
        print(f"phase {phase}:   split (ms): " + ", ".join(
            f"{label} {ms:.3f}" for label, ms in split.items()))
    if host_top:
        host = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU]
        launches = sum(e.count for e in host if e.key == "cudaLaunchKernel")
        print(f"phase {phase}:   host: {launches} cudaLaunchKernel calls; "
              f"operators by host self time:")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[
                :host_top]:
            print(f"phase {phase}:   {e.self_cpu_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<5d} {e.key[:90]}")
    return out, wall, busy


def _profile_round(server, labels):
    """One more warm round under torch.profiler: where a select's time
    goes (host phases, device busy time, the kernels by device time)."""
    import numpy as np

    (ids, res), _, _ = profile_device(
        3, "select", lambda: server.select_cohort(64))
    print(f"phase 3: profiled select was {res.source}, engine solve "
          f"{res.seconds * 1e3:.3f} ms")
    server.observe_round(0.5 + 0.4 * float(np.mean(labels[ids] != 0)))


def phase3(x, labels):
    """Drive the server on the card; returns the fused kernels' launch
    counts on this path."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.cohort import CohortConfig, CohortEngine
    from repro_torch.kernels import nystrom as kn
    from repro_torch.launch.serve import CohortServer

    # method "auto": N > dense_cutoff takes the mesh route, 1-way on one
    # card
    config = CohortConfig(num_clusters=K, use_pallas=True, num_landmarks=M)
    with plain_on_card_forbidden():
        server = CohortServer(N, D, policy="dqn", seed=ENGINE_SEED,
                              config=config)
        if server.device.type != "cuda":
            raise AssertionError(f"server runs on {server.device}")
        server.update_embeddings(np.arange(N), x)
        rng = np.random.default_rng(SEED + 2)
        table0 = server.embeds
        results = []
        kn.reset_launch_counts()
        for r in range(5):
            ids, res = server.select_cohort(64)
            torch.cuda.synchronize()
            useful = float(np.mean(labels[ids] != 0))
            reward = server.observe_round(0.5 + 0.4 * useful)
            server.update_embeddings(
                ids, server.embeds[ids]
                + 0.01 * rng.normal(size=(len(ids), D)).astype(np.float32))
            results.append(res)
            print(f"phase 3: round {r}: {len(ids)} clients, "
                  f"{res.method}/{res.source}, select "
                  f"{server.last_select_s:.4f} s, reward {reward:+.3f}")
        torch.cuda.synchronize()
        launches = {name: kn.LAUNCH_COUNTS[name] for name in FUSED}
        print("phase 3: launches", json.dumps(launches))
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"{name} never launched on the path")
        first = results[0]
        if any(res.method != "sharded" for res in results):
            raise AssertionError("the path did not take the mesh route")
        if first.source != "cold" or results[1].source not in ("warm",
                                                               "cache"):
            raise AssertionError(
                f"sources {[res.source for res in results]}: expected a "
                f"cold solve, then warm or cache")
        for res in results:
            shape_ok = (res.assign.shape == (N,)
                        and res.embedding.shape == (N, K))
            if not shape_ok or not np.isfinite(res.embedding).all():
                raise AssertionError("malformed or non-finite solve")
        # the warm rounds re-seed k-means from each new table, so only
        # the cold solve is held to the limit (see ENGINE_SEED)
        p = purity(first.assign, labels)
        warm = [round(float(purity(r.assign, labels)), 5)
                for r in results[1:]]
        print(f"phase 3: cold purity {p:.5f} (limit 0.95); warm rounds "
              f"{warm}")
        if p < 0.95:
            raise AssertionError(f"purity {p:.4f} < 0.95")
        print("phase 3: stats", json.dumps(server.stats(), default=float))
        _profile_round(server, labels)

        again = CohortEngine(config, seed=ENGINE_SEED).select(table0)
        if not np.array_equal(again.assign, first.assign):
            raise AssertionError("a second cold solve is not bit-identical")
        print("phase 3: second cold engine: bit-identical assignments")
        for dtype in ("bf16", "int8"):
            cfg = dataclasses.replace(config, affinity_dtype=dtype)
            res = CohortEngine(cfg, seed=ENGINE_SEED).select(table0)
            p = purity(res.assign, labels)
            if p < 0.95:
                raise AssertionError(f"{dtype} select purity {p:.4f} < 0.95")
            print(f"phase 3: {dtype} select {res.seconds:.4f} s, "
                  f"purity {p:.4f}")

    cpu = CohortEngine(config, seed=ENGINE_SEED, device="cpu").select(table0)
    if not same_partition(cpu.assign, first.assign):
        raise AssertionError("the card's partition differs from the CPU's")
    print(f"phase 3: CPU solve ({cpu.seconds:.2f} s) gives the same "
          f"partition")
    return launches


# -- phase 4 ----------------------------------------------------------------

def _print_round(phase, res):
    t = " ".join(f"{k} {v:.4f}" for k, v in res.timings.items())
    print(f"phase {phase}: round {res.round_idx}: acc {res.accuracy:.4f} "
          f"loss {res.loss:.4f} reward {res.reward:+.3f} selected "
          f"{res.selected.tolist()} | {res.seconds:.4f} s: {t}")


def decisive_pool_noise(runner):
    """A runner's ``_pool_noise`` giving 64 to one random entry of each
    pooling window and 0 to the rest, drawn from the runner's own CPU
    seed: the winner never depends on the probabilities (log p lies in
    [-20.7, 0]), so no decision can flip between two devices."""
    import torch
    from repro_torch.models.cnn import pool_noise_shape

    cfg = runner.cfg

    def pool_noise(k):
        gen = torch.Generator().manual_seed(cfg.seed * 100_003
                                            + runner.round_idx)
        shape = (k, *pool_noise_shape(cfg.batch_size,
                                      runner.spec.image_size))

        def draw(step):
            win = torch.randint(0, shape[-1], shape[:-1], generator=gen)
            one_hot = torch.nn.functional.one_hot(win, shape[-1])
            return (64.0 * one_hot.float()).to(runner.device)

        return draw

    return pool_noise


def _small_dqre_sc_select():
    """One small dqre_sc round on the card; its selection is held against
    a CPU policy fed the same state.

    The engine seeds k-means from the SHA-1 of the embeddings' bytes
    (cohort/engine.py), and training on two devices does not give the
    same bytes, so a whole CPU round would cluster other points.  Here
    the CPU policy gets the card round's own state: the same bytes, so
    the same seeds, and the card's engine (B7 on the card) must give the
    CPU engine's partition and the same ClusterPolicy draw.
    """
    import numpy as np
    from repro_torch.fed.rounds import FederatedRunner, RunnerConfig
    from repro_torch.kernels import ops

    cfg = RunnerConfig(**SMALL_FL)
    card = FederatedRunner(cfg, device="cuda")
    states = []
    select = card.policy.select

    def recording_select(state):
        states.append(state)
        return select(state)

    card.policy.select = recording_select
    with plain_on_card_forbidden():
        ops.reset_launch_counts()
        res = card.run_round()
        launches = ops.LAUNCH_COUNTS["pairwise_sq_dists"]
    if launches == 0:
        raise AssertionError("the small dqre_sc round launched no B7")
    # the policy keeps the select's partition (update does not touch it)
    card_policy, card_ids = card.policy, res.selected
    cpu_policy = FederatedRunner(cfg, device="cpu").policy
    cpu_ids = cpu_policy.select(states[0])
    same_labels = np.array_equal(card_policy._last_assign,
                                 cpu_policy._last_assign)
    print(f"phase 4: small dqre_sc round on the card: acc "
          f"{res.accuracy:.4f} loss {res.loss:.5f}, {launches} B7 launches; "
          f"cohort {card_ids.tolist()}, CPU policy on the same state "
          f"{cpu_ids.tolist()}; partition label for label: {same_labels}")
    if not same_partition(card_policy._last_assign, cpu_policy._last_assign):
        raise AssertionError("the card's partition differs from the CPU's "
                             "on the same embeddings")
    if not np.array_equal(card_ids, cpu_ids):
        raise AssertionError("the card's cohort differs from the CPU's on "
                             "the same embeddings")
    if len(set(card_ids.tolist())) != cfg.clients_per_round:
        raise AssertionError(f"cohort {card_ids.tolist()}")


def phase4():
    """The paper's loop on the card; returns its pairwise-distance
    launches."""
    import numpy as np
    import torch
    from repro_torch.fed.rounds import FederatedRunner, RunnerConfig
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import gumbel_noise, pool_noise_shape

    cfg = RunnerConfig(**PAPER_FL)
    t0 = time.perf_counter()
    runner = FederatedRunner(cfg)
    if runner.device.type != "cuda":
        raise AssertionError(f"runner on {runner.device}")
    print(f"phase 4: runner set up in {time.perf_counter() - t0:.2f} s "
          f"({len(runner.x_train)} training images, "
          f"{cfg.num_clients} clients)")
    # the host's share of a local step: one pooling-noise draw
    for k in (cfg.clients_per_round, 32):
        draw = gumbel_noise(0, (k, *pool_noise_shape(cfg.batch_size, 28)),
                            "cuda")
        times = []
        for step in range(5):
            t0 = time.perf_counter()
            draw(step)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"phase 4: pooling noise of {k} clients, one step: median "
              f"{statistics.median(times) * 1e3:.2f} ms on the host "
              f"(drawn on the CPU, then copied)")
    history = []
    with plain_on_card_forbidden():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        runner.warmup()
        torch.cuda.synchronize()
        print(f"phase 4: warm-up of {cfg.num_clients} clients "
              f"{time.perf_counter() - t0:.3f} s")
        for _ in range(2):
            history.append(runner.run_round())
            _print_round(4, history[-1])
        res, wall, busy = profile_device(4, "round", runner.run_round)
        history.append(res)
        _print_round(4, res)
        torch.cuda.synchronize()
        launches = ops.LAUNCH_COUNTS["pairwise_sq_dists"]
        solves = runner.policy.engine.stats["solves"]
    print(f"phase 4: pairwise_sq_dists launches {launches}, engine solves "
          f"{solves}, launches {json.dumps(ops.LAUNCH_COUNTS)}")
    if launches != solves or launches == 0:
        raise AssertionError(f"{launches} pairwise_sq_dists launches for "
                             f"{solves} engine solves")
    for res in history:
        if not np.isfinite(res.loss):
            raise AssertionError(f"round {res.round_idx}: loss {res.loss}")
        if len(set(res.selected.tolist())) != cfg.clients_per_round:
            raise AssertionError(f"round {res.round_idx}: cohort "
                                 f"{res.selected.tolist()}")
    print(f"phase 4: the profiled round's device idle share "
          + (f"{1 - busy / wall:.4f}" if busy else "not measured"))

    _small_dqre_sc_select()

    # one small round on the card and on the CPU, under fedavg: its
    # cohort is numpy's draw on both, so the round's training is compared
    # on the same clients
    small = RunnerConfig(**dict(SMALL_FL, policy="fedavg"))
    for noise in ("gumbel", "decisive"):
        rounds = []
        for device in ("cuda", "cpu"):
            runner = FederatedRunner(small, device=device)
            if noise == "decisive":
                runner._pool_noise = decisive_pool_noise(runner)
            rounds.append(runner.run_round())
        card, cpu = rounds
        print(f"phase 4: small round, {noise} pooling noise: card acc "
              f"{card.accuracy:.4f} loss {card.loss:.5f} "
              f"{card.selected.tolist()}; CPU acc {cpu.accuracy:.4f} loss "
              f"{cpu.loss:.5f} {cpu.selected.tolist()}")
    # held with decisive noise: with Gumbel noise a pooling decision
    # whose two best scores lie within one f32 ulp can flip between
    # cuDNN's and the CPU's convolutions (ROADMAP §C)
    if not np.array_equal(card.selected, cpu.selected):
        raise AssertionError("the card's cohort differs from the CPU's")
    if abs(card.accuracy - cpu.accuracy) > 0.01:
        raise AssertionError("card and CPU accuracy differ by > 0.01")
    if abs(card.loss - cpu.loss) > 1e-3 * abs(cpu.loss):
        raise AssertionError("card and CPU loss differ by > 1e-3 relative")
    return launches


# -- phase 5 ----------------------------------------------------------------

def phase5(x, labels):
    """The other routes of Algorithm I; returns the launches of B5, B6,
    B7 (dense) and B8 on them, and of B1–B4 in the m=4096 engine."""
    import numpy as np
    import torch
    from repro_torch.cohort import CohortConfig, CohortEngine
    from repro_torch.core import spectral
    from repro_torch.kernels import ops, ref

    launches = {}
    rng = np.random.default_rng(SEED + 4)
    with plain_on_card_forbidden():
        # the engine on the subspace solver: m > eigh_cutoff
        eng = CohortEngine(CohortConfig(
            num_clusters=K, num_landmarks=M_SUBSPACE, use_pallas=True),
            seed=ENGINE_SEED)
        counts = []
        fused = {name: [] for name in EXTRA_ROWS.values()}
        results = []
        for table in (x, x + 0.01 * rng.normal(size=x.shape).astype(
                np.float32)):
            ops.reset_launch_counts()
            results.append(eng.select(table))
            torch.cuda.synchronize()
            counts.append(ops.LAUNCH_COUNTS["panel_matmul"])
            for name, n in fused.items():
                n.append(ops.LAUNCH_COUNTS[name])
        cold, warm = results
        p_cold, p_warm = purity(cold.assign, labels), purity(warm.assign,
                                                             labels)
        print(f"phase 5: m={M_SUBSPACE} engine: {cold.source} select "
              f"{cold.seconds:.4f} s, {counts[0]} panel_matmul launches, "
              f"purity {p_cold:.5f}; {warm.source} select "
              f"{warm.seconds:.4f} s, {counts[1]} launches, purity "
              f"{p_warm:.5f}; B1-B4 launches {json.dumps(fused)}")
        if (cold.source, warm.source) != ("cold", "warm"):
            raise AssertionError(f"sources {cold.source}, {warm.source}")
        if counts != [82, 18]:
            raise AssertionError(f"panel_matmul launches {counts}, "
                                 f"expected [82, 18]")
        if any(n != [1, 1] for n in fused.values()):
            raise AssertionError(f"B1-B4 launches {fused}, expected "
                                 f"[1, 1] each")
        if p_cold < 0.95:
            raise AssertionError(f"m={M_SUBSPACE} purity {p_cold:.4f}")
        launches["panel_matmul"] = sum(counts)
        for row, name in EXTRA_ROWS.items():
            launches[row] = sum(fused[name])
        # where a warm select's time goes at m=4096
        table = x + 0.02 * rng.normal(size=x.shape).astype(np.float32)
        res, _, _ = profile_device(5, f"m={M_SUBSPACE} select",
                                   lambda: eng.select(table))
        print(f"phase 5: profiled select was {res.source}, "
              f"{res.seconds:.4f} s")

        xt = torch.tensor(x, device="cuda")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        assign, y, _ = spectral.spectral_cluster(
            torch.Generator().manual_seed(SPECTRAL_SEED), xt, K,
            method="nystrom", use_pallas=True, num_landmarks=M)
        torch.cuda.synchronize()
        p = purity(assign.cpu().numpy(), labels)
        launches["rbf_cross_affinity"] = ops.LAUNCH_COUNTS[
            "rbf_cross_affinity"]
        print(f"phase 5: unfused nystrom spectral_cluster at N={N}, m={M}: "
              f"{time.perf_counter() - t0:.4f} s, "
              f"{launches['rbf_cross_affinity']} rbf_cross_affinity "
              f"launches, purity {p:.5f}")
        if launches["rbf_cross_affinity"] != 1 or p < 0.95:
            raise AssertionError("unfused nystrom route failed")
        if not torch.isfinite(y).all():
            raise AssertionError("non-finite nystrom embedding")

        dense = xt[:N_DENSE]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card, _, _ = spectral.spectral_cluster(
            torch.Generator().manual_seed(SPECTRAL_SEED), dense, K,
            use_pallas=True)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        launches[B7_DENSE] = ops.LAUNCH_COUNTS["pairwise_sq_dists"]
        if launches[B7_DENSE] != 1:
            raise AssertionError("dense route did not launch B7 once")

        ops.reset_launch_counts()
        a = ops.rbf_affinity(dense, 0.37)
        torch.cuda.synchronize()
        launches["rbf_affinity"] = ops.LAUNCH_COUNTS["rbf_affinity"]
    want = ref.rbf_affinity_ref(dense, 0.37)
    if launches["rbf_affinity"] != 1 or not torch.all(a.diagonal() == 0):
        raise AssertionError("rbf_affinity route failed")
    if float((a - want).abs().max()) > LIMIT_MAX_REL:
        raise AssertionError("rbf_affinity disagrees with its plain version")
    t0 = time.perf_counter()
    cpu, _, _ = spectral.spectral_cluster(
        torch.Generator().manual_seed(SPECTRAL_SEED), dense.cpu(), K,
        use_pallas=True)
    print(f"phase 5: dense spectral_cluster at n={N_DENSE}: card "
          f"{dense_s:.4f} s, CPU {time.perf_counter() - t0:.4f} s, purity "
          f"{purity(card.cpu().numpy(), labels[:N_DENSE]):.5f}")
    if not same_partition(card.cpu().numpy(), cpu.numpy()):
        raise AssertionError("dense: the card's partition differs from the "
                             "CPU's")
    print(f"phase 5: rbf_affinity at n={N_DENSE}: 1 launch, diagonal zero")
    return launches


# -- phase 2, the LM kernels -----------------------------------------------

def _flash_bound(B, S, T, H, K, dh, causal, window, dtype, dv=None):
    """(bound_ms, bound_by, f32 CUDA-core bound ms) of one B9 call.

    The work is ``kernels/flash_attention.py::flash_work``'s, which the
    dry run counts too: over the score entries the masks leave (this
    call's data), q.k is 2·dh, p.v 2·dv, the softmax ~5 (scale, max,
    subtract, exp, sum); q, k, v read once, out written once.  bf16
    inputs take the tensor cores' peak, f32 ones the CUDA cores'; the
    f32 figure is also returned, the bound of this kernel's f32
    arithmetic.
    """
    from repro_torch.kernels.flash_attention import flash_work
    ops, nbytes = flash_work(B, S, T, H, K, dh, dh if dv is None else dv,
                             causal=causal, window=window,
                             itemsize=2 if dtype == "bf16" else 4)
    peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return (*bound, max(ops / PEAK_F32_FLOPS * 1e3, t_bytes))


def _ssd_bound(B, c, Q, H, P, G, N, bc_dtype):
    """(bound_ms, bound_by) of one B10 call, over
    ``kernels/ssd.py::ssd_work`` (the dry run's count too): C.B^T at the
    peak of B and C's type, once per (batch, chunk, group); the decay,
    M.x and the state at f32, per head; xdt, cs, B, C read once, y and
    the states written once.
    """
    from repro_torch.kernels.ssd import ssd_work
    ops_bc, ops_f32, nbytes = ssd_work(
        B, c, Q, H, P, G, N, bc_itemsize=2 if bc_dtype == "bf16" else 4)
    peak_bc = PEAK_BF16_FLOPS if bc_dtype == "bf16" else PEAK_F32_FLOPS
    t_ops = (ops_bc / peak_bc + ops_f32 / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _lm_kernel_cases():
    """{kernel: [(label, shape, kernel call, plain call, limit, bound,
    library call)]}: the path shape first, then ragged ones."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + 5)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}

    def t(shape, dtype="f32", scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale,
                            dtype=dt[dtype], device="cuda")

    def flash(B, S, T, H, K, dh, dtype, causal=True, window=None,
              library=False, dv=None, scale=None):
        dv = dh if dv is None else dv
        q, k, v = t((B, S, H, dh), dtype), t((B, T, K, dh), dtype), \
            t((B, T, K, dv), dtype)
        kw = dict(causal=causal, window=window, scale=scale)
        lib = None
        if library:
            def lib():
                # the yardstick: one PyTorch call, the same function
                return torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, scale=scale,
                    enable_gqa=True).transpose(1, 2)
        limit = "bf16" if dtype == "bf16" else LIMIT_F32_REL
        return ((B, S, T, H, K, (dh, dv), dtype, causal, window, scale),
                lambda: ops.flash_attention(q, k, v, **kw),
                lambda: ref.flash_attention_ref(q, k, v, **kw), limit,
                _flash_bound(B, S, T, H, K, dh, causal, window, dtype, dv),
                lib)

    def ssd(B, c, Q, H, P, G, N, bc_dtype):
        xdt = t((B, c, Q, H, P))
        # the cumulative dt·A of a chunk: falling, steps of up to -0.1
        cs = torch.cumsum(-torch.tensor(rng.random((B, c, Q, H)) * 0.1,
                                        dtype=torch.float32, device="cuda"),
                          dim=2)
        Bm, Cm = t((B, c, Q, G, N), bc_dtype), t((B, c, Q, G, N), bc_dtype)
        return ((B, c, Q, H, P, G, N, bc_dtype),
                lambda: ops.ssd_chunk(xdt, cs, Bm, Cm),
                lambda: ref.ssd_chunk_ref(xdt, cs, Bm, Cm), LIMIT_F32_REL,
                (*_ssd_bound(B, c, Q, H, P, G, N, bc_dtype), None), None)

    fp = FLASH_PATH
    sp = SSD_PATH
    flash_cases = [("path", *flash(**fp, dtype="bf16", library=True)),
                   # the same 33 KV tiles a row, held to the f32 limit
                   ("path f32", *flash(**fp, dtype="f32")),
                   ("gemma", *flash(**FLASH_GEMMA, dtype="bf16",
                                    library=True)),
                   ("gemma f32", *flash(**FLASH_GEMMA, dtype="f32")),
                   ("moonshot", *flash(**FLASH_MOONSHOT, dtype="bf16",
                                       library=True)),
                   ("mla", *flash(**FLASH_MLA, dtype="bf16", library=True)),
                   ("mla f32", *flash(**FLASH_MLA, dtype="f32",
                                      library=True)),
                   ("internvl", *flash(**FLASH_INTERNVL, dtype="bf16",
                                       library=True)),
                   ("seamless enc", *flash(**FLASH_SEAMLESS_ENC,
                                           dtype="bf16", library=True)),
                   ("seamless enc f32", *flash(**FLASH_SEAMLESS_ENC,
                                               dtype="f32", library=True)),
                   ("seamless cross", *flash(**FLASH_SEAMLESS_CROSS,
                                             dtype="bf16", library=True)),
                   ("seamless self", *flash(**FLASH_SEAMLESS_SELF,
                                            dtype="bf16", library=True)),
                   ("llama4 tp", *flash(**FLASH_LLAMA4_TP, dtype="bf16",
                                        library=True)),
                   ("jamba tp", *flash(**FLASH_JAMBA_TP, dtype="bf16",
                                       library=True)),
                   ("mla tp", *flash(**FLASH_MLA_TP, dtype="bf16",
                                     library=True,
                                     scale=192 ** -0.5)),
                   ("enc tp", *flash(**FLASH_SEAMLESS_ENC_TP, dtype="bf16",
                                     library=True)),
                   ("self tp", *flash(**FLASH_SEAMLESS_SELF_TP,
                                      dtype="bf16", library=True)),
                   ("cross tp", *flash(**FLASH_SEAMLESS_CROSS_TP,
                                       dtype="bf16", library=True))]
    for dtype in ("f32", "bf16"):
        flash_cases += [
            ("ragged", *flash(2, 33, 33, 4, 4, 32, dtype)),          # G = 1
            ("T>S G=7", *flash(1, 50, 90, 7, 1, 64, dtype)),
            ("noncausal", *flash(2, 70, 70, 8, 2, 128, dtype,
                                 causal=False)),
            # non-causal with Sq != T: a prompt against a long source,
            # and more queries than keys
            ("nc S<T", *flash(2, 37, 1000, 16, 16, 64, dtype,
                              causal=False)),
            ("nc S>T", *flash(1, 300, 45, 4, 4, 32, dtype, causal=False)),
            ("window 8", *flash(1, 97, 130, 4, 2, 64, dtype, window=8)),
            # MLA's widths with a scale other than 1/sqrt(dh), ragged
            ("mla rag", *flash(1, 77, 100, 8, 8, 192, dtype, dv=128,
                               scale=0.11)),
            ("mla red", *flash(2, 33, 50, 4, 4, 48, dtype, dv=32,
                               window=16, scale=0.3)),
        ]
    ssd_cases = [("path", *ssd(**sp, bc_dtype="bf16")),
                 ("jamba", *ssd(**SSD_JAMBA, bc_dtype="bf16")),
                 ("jamba tp", *ssd(**SSD_JAMBA_TP, bc_dtype="bf16"))]
    for bc in ("f32", "bf16"):
        ssd_cases += [
            ("Q=8 G=2", *ssd(2, 3, 8, 4, 16, 2, 16, bc)),
            ("Q=19", *ssd(1, 2, 19, 2, 16, 1, 16, bc)),
            # B10's head sets: 80 heads of one group, a partial last set,
            # two groups
            ("H=80", *ssd(1, 2, 256, 80, 64, 1, 128, bc)),
            ("H=6", *ssd(1, 1, 256, 6, 64, 1, 128, bc)),
            ("H=8 G=2", *ssd(1, 2, 256, 8, 64, 2, 128, bc)),
            ("jamba Q=19", *ssd(1, 2, 19, 6, 64, 1, 16, bc)),
        ]
    return {"flash_attention": flash_cases, "ssd_chunk": ssd_cases}


# phase 2's LM cases at shapes no served path reaches
UNSERVED = ("jamba",)


def _case_error(got, want, limit):
    """(error, its limit, text of the limit) of one output: max |diff|
    over the largest |want| for a float limit; for "bf16" the largest
    |diff| over 2^-7 |want| + 1e-3 rms(want), elementwise."""
    import torch
    diff = (got.float() - want.float()).abs()
    w = want.float()
    if limit == "bf16":
        rel, floor = LIMIT_BF16_ELEM
        den = rel * w.abs() + floor * torch.sqrt(torch.mean(w * w))
        return (float((diff / den).max()), 1.0,
                "1 of 2^-7|want| + 1e-3 rms(want)")
    return float(diff.max()) / float(w.abs().max()), limit, \
        f"{limit:.0e} of max|want|"


def phase2_lm():
    """B9 and B10 against their plain versions; timed at the path shape.
    Returns {name: record}."""
    import torch

    records = {}
    for name, cases in _lm_kernel_cases().items():
        rec = records[name] = {"name": name, "route": "cuda",
                               "source": KERNELS[name][1],
                               "replaces": KERNELS[name][0],
                               "max_abs_err": 0.0}
        worst = (0.0, None, None)
        for label, shape, kern, plain, limit, bound, library in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err, lim, lim_text, abs_err = 0.0, None, None, 0.0
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype \
                        or not torch.isfinite(g).all():
                    raise AssertionError(f"{name} {label}: malformed output")
                e, lim, lim_text = _case_error(g, w, limit)
                err = max(err, e)
                abs_err = max(abs_err, float((g.float() - w.float()).abs()
                                             .max()))
            rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
            ok = err <= lim
            print(f"phase 2: {name:25s} {label:9s} {shape} err {err:.3e} "
                  f"(limit {lim_text}; max abs {abs_err:.3e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {label}: error {err:.3e} > "
                                     f"{lim_text}")
            if err / lim > worst[0]:
                worst = (err / lim, label, f"{err:.3e} against {lim_text}")
            if name == "ssd_chunk" and not all(
                    torch.equal(a, b) for a, b in zip(kern(), got)):
                raise AssertionError(f"{name} {label}: a repeat call "
                                     f"differs")
            # timed: the path shape (the JSON row), gemma-2b's,
            # moonshot's, deepseek-v3's (MLA), internvl2-26b's and
            # seamless-m4t-medium's prefills, and the jamba shape (0
            # launches on the paths)
            if label not in ("path", "gemma", "gemma f32", "moonshot",
                             "mla", "mla f32", "internvl", "seamless enc",
                             "seamless enc f32", "seamless cross",
                             "seamless self", "llama4 tp", "jamba tp",
                             "mla tp", "enc tp", "self tp", "cross tp",
                             *UNSERVED):
                continue
            ms, plain_ms = time_ms(kern), time_ms(plain)
            bound_ms, bound_by, f32_bound = bound
            library_ms = None
            if library is not None:
                lib_out = library()
                torch.cuda.synchronize()
                lib_err = float((lib_out.float() - want[0].float()).abs()
                                .max() / want[0].float().abs().max())
                print(f"phase 2: {name:25s} {label:9s} library call (SDPA) "
                      f"agrees to {lib_err:.3e} of the largest entry, "
                      f"{_case_error(lib_out, want[0], limit)[0]:.3f} of "
                      f"the kernel's limit")
                times = vs_library(kern, library)
                ms, library_ms = times[:2]
                print_vs_library(name, label, times, bound_ms, bound_by)
            if label == "path":
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms)
            f32_note = ("" if f32_bound is None else
                        f", f32 CUDA-core bound {f32_bound:.4f} ms")
            print(f"phase 2: {name:25s} {label:9s} {ms:.4f} ms (device "
                  f"{ms_text(device_ms(kern))}; plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.5f} ms by {bound_by}{f32_note}, library "
                  f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'})"
                  + ("; 0 launches on the paths" if label in UNSERVED
                     else ""))
        print(f"phase 2: {name:25s} worst error {worst[2]} ({worst[1]})"
              + ("; every case bit-identical on a repeat call"
                 if name == "ssd_chunk" else ""))
    return records


# -- phase 6 ----------------------------------------------------------------

def _has_ssm(cfg):
    from repro_torch.models import transformer as T
    return any(mixer == "ssm" for mixer, _ in T.layer_types(cfg))


def _lm_requests(cfg, arch, rng, lens=None, new_tokens=LM_NEW_TOKENS):
    """Prompts of the given lengths, or LM_REQUESTS of 256–2048 tokens
    (multiples of the bucket for an arch with Mamba layers: the reference
    pads them into the recurrence)."""
    import numpy as np
    from repro_torch.launch.serve import Request

    lo, hi = LM_PROMPT
    reqs = []
    for i in range(LM_REQUESTS if lens is None else len(lens)):
        if lens is not None:
            plen = lens[i]
        elif _has_ssm(cfg):
            plen = LM_BUCKET * int(rng.integers(lo // LM_BUCKET,
                                                hi // LM_BUCKET + 1))
        else:
            plen = int(rng.integers(lo, hi + 1))
        reqs.append(Request(i, rng.integers(0, cfg.vocab_size, plen).astype(
            np.int32), new_tokens))
    return reqs


@contextlib.contextmanager
def flash_shapes(roles=False):
    """Record (dh, dv, H, K) of every B9 call on the card inside the
    block (the list it yields); with ``roles``, (dh, dv, H, K, S, T,
    causal)."""
    from repro_torch.kernels import flash_attention as FA

    calls = []
    real = FA.flash_attention

    def recorded(q, k, v, **kw):
        if q.is_cuda:
            call = (q.shape[3], v.shape[3], q.shape[2], k.shape[2])
            if roles:
                call += (q.shape[1], k.shape[1], kw.get("causal", True))
            calls.append(call)
        return real(q, k, v, **kw)

    FA.flash_attention = recorded
    try:
        yield calls
    finally:
        FA.flash_attention = real


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def _serve_full(arch, lens=None, new_tokens=LM_NEW_TOKENS, phase="6",
                groups=None, cfg=None, flash_shape=None, after=None):
    """One full-width arch on the card (``cfg``, or the arch's config),
    serving ``lens`` prompts (the seed's 6 when None); returns its kernel
    launches.  ``groups`` splits the profiled prefill's and decode step's
    device time (see ``profile_device``); ``flash_shape`` is the (dh, dv,
    H, K) every served B9 launch must have; ``after(server)`` runs before
    the server is freed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer as T

    cfg = get_config(arch) if cfg is None else cfg
    attn_layers = sum(m in ("attn", "mla") for m, _ in T.layer_types(cfg))
    ssm_layers = sum(m == "ssm" for m, _ in T.layer_types(cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = Server(cfg, LM_BATCH, LM_MAX_SEQ, seed=LM_SEED,
                    prefill_bucket=LM_BUCKET)
    torch.cuda.synchronize()
    if server.device.type != "cuda":
        raise AssertionError(f"server on {server.device}")
    print(f"phase {phase}: {arch}: {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters in "
          f"{cfg.param_dtype}, {cfg.num_layers} layers, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s ({_numel(server.params) / 1e9:.3f}"
          f"e9 in the tree; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated)")
    reqs = _lm_requests(cfg, arch, np.random.default_rng(LM_SEED), lens,
                        new_tokens)
    print(f"phase {phase}: {arch}: prompt lengths "
          f"{[len(r.prompt) for r in reqs]}")
    with plain_on_card_forbidden(), ops.use_pallas_scoped(True), \
            flash_shapes() as shapes:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = server.serve_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: ops.LAUNCH_COUNTS[k] for k in ("flash_attention",
                                                       "ssd_chunk")}
    stats = server.stats()
    prefills = stats["prefills"]
    print(f"phase {phase}: {arch}: {len(done)} requests answered in "
          f"{wall:.3f} s; {prefills} prefills, "
          f"{stats['prefill_seconds'] / prefills * 1e3:.2f}"
          f" ms a request; {stats['decode_steps']} decode steps, "
          f"{stats['decode_tokens']} tokens, {server.last_decode_tok_s:.1f} "
          f"decode tok/s (EMA {stats['tok_s_ema']:.1f}); launches "
          f"{json.dumps(launches)}")
    want = {"flash_attention": attn_layers * prefills,
            "ssd_chunk": ssm_layers * prefills}
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, expected {want}")
    seen = sorted(set(shapes))
    print(f"phase {phase}: {arch}: B9 (dh, dv, H, K) of the served "
          f"launches: {seen}")
    if flash_shape is not None and seen != [flash_shape]:
        raise AssertionError(f"{arch}: B9 shapes {seen}, expected "
                             f"{flash_shape}")
    if len(done) != len(reqs) or stats["truncated"] or any(
            len(r.generated) != new_tokens
            or not all(0 <= x < cfg.vocab_size for x in r.generated)
            for r in done):
        raise AssertionError(f"{arch}: malformed answers")
    print(f"phase {phase}: {arch}: request 0 generated "
          f"{done[0].generated[:8]}")

    # one profiled prefill of the longest prompt, one decode step
    sched = server.scheduler
    toks = torch.tensor(np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab_size, (1, LM_PROMPT[1])), device="cuda")
    with ops.use_pallas_scoped(True):
        (logits, _), _, _ = profile_device(
            phase, f"{arch} prefill S={LM_PROMPT[1]}",
            lambda: T.lm_prefill_slot(server.params, cfg, {"tokens": toks},
                                      sched.caches, 0), host_top=6,
            groups=groups)
        if logits.shape != (1, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{arch}: malformed prefill logits")
        pos = torch.full((LM_BATCH,), LM_PROMPT[1], device="cuda")
        tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device="cuda")
        profile_device(phase, f"{arch} decode step (batch {LM_BATCH})",
                       lambda: T.lm_decode_step(server.params, cfg, tok,
                                                sched.caches, pos),
                       host_top=6, groups=groups)
    print(f"phase {phase}: {arch}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if after is not None:
        after(server)
    del server, sched
    torch.cuda.empty_cache()
    return launches


def _reduced_card_vs_cpu(arch, phase="6"):
    """Reduced f32 config, the same weights on the card and the CPU.
    Returns the card prefill's kernel launches: one B9 an attention
    layer, one B10 a Mamba layer."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import DecodeScheduler, Request
    from repro_torch.models import transformer as T

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on")
    cfg = get_config(arch).reduced()
    params = T.init_lm(torch.Generator().manual_seed(LM_SEED), cfg,
                       device="cpu")
    on_card = T.params_to(params, "cuda")
    rng = np.random.default_rng(LM_SEED + 2)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 37)))
    logits = {}
    with ops.use_pallas_scoped(True):
        for dev, p in (("cuda", on_card), ("cpu", params)):
            caches = T.init_lm_cache(cfg, 2, 64, device=dev)
            ops.reset_launch_counts()
            out, _ = T.lm_prefill(p, cfg, {"tokens": toks.to(dev)}, caches)
            logits[dev] = out.cpu()
            if dev == "cuda":
                launches = {k: ops.LAUNCH_COUNTS[k]
                            for k in ("flash_attention", "ssd_chunk")}
    mixers = [mixer for mixer, _ in T.layer_types(cfg)]
    want = {"flash_attention": mixers.count("attn") + mixers.count("mla"),
            "ssd_chunk": mixers.count("ssm")}
    if launches != want:
        raise AssertionError(f"reduced {arch}: launches {launches}, "
                             f"expected {want}")
    err = float((logits["cuda"] - logits["cpu"]).abs().max()
                / logits["cpu"].abs().max())
    print(f"phase {phase}: reduced {arch}: prefill logits card vs CPU "
          f"{err:.3e} "
          f"of max |logit| (limit {LIMIT_LOGIT_REL:.0e})")
    if err > LIMIT_LOGIT_REL:
        raise AssertionError(f"reduced {arch}: logits differ by {err:.3e}")
    if cfg.num_prefix_embeds:
        # a VLM prompt: the prefix embeddings, then the tokens
        pfx = torch.tensor(rng.normal(size=(2, cfg.num_prefix_embeds,
                                            cfg.d_model)) * 0.02,
                           dtype=torch.float32)
        with ops.use_pallas_scoped(True):
            for dev, p in (("cuda", on_card), ("cpu", params)):
                ops.reset_launch_counts()
                out, _ = T.lm_prefill(
                    p, cfg, {"tokens": toks.to(dev),
                             "prefix_embeds": pfx.to(dev)},
                    T.init_lm_cache(cfg, 2, 64, device=dev))
                logits[dev] = out.cpu()
                if dev == "cuda":
                    n = ops.LAUNCH_COUNTS["flash_attention"]
        err = float((logits["cuda"] - logits["cpu"]).abs().max()
                    / logits["cpu"].abs().max())
        print(f"phase {phase}: reduced {arch}: prefill with "
              f"{cfg.num_prefix_embeds} prefix embeddings, card vs CPU "
              f"{err:.3e} of max |logit|; {n} B9 launches")
        if err > LIMIT_LOGIT_REL or n != want["flash_attention"]:
            raise AssertionError(f"reduced {arch}: prefix prefill differs "
                                 f"by {err:.3e}, {n} B9 launches")

    lens = ([(16, 6), (40, 4), (24, 7)] if _has_ssm(cfg)
            else [(5, 6), (37, 4), (18, 7)])
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in lens]

    def serve(dev, p, batch, which):
        sched = DecodeScheduler(cfg, p, batch, 64, device=dev)
        for i in which:
            sched.submit(Request(i, prompts[i], lens[i][1]))
        with ops.use_pallas_scoped(True):
            return {r.uid: r.generated for r in sched.drain()}

    card = serve("cuda", on_card, 2, range(3))
    cpu = serve("cpu", params, 2, range(3))
    solo = {}
    for i in range(3):
        solo.update(serve("cuda", on_card, 1, [i]))
    print(f"phase {phase}: reduced {arch}: card {card}; CPU same: "
          f"{card == cpu}; "
          f"batch-1 oracle same: {card == solo}")
    if card != cpu:
        raise AssertionError(f"reduced {arch}: card tokens != CPU tokens")
    if card != solo:
        raise AssertionError(f"reduced {arch}: batch != batch-1 oracle")
    print(f"phase {phase}: reduced {arch}: card prefill launches "
          f"{json.dumps(launches)}")
    return launches


def phase6():
    """The LM server on the card; returns {kernel: launches}."""
    launches = {"flash_attention": 0, "ssd_chunk": 0}
    runs = [(arch, None, LM_NEW_TOKENS) for arch in LM_ARCHS]
    runs.append((GEMMA_ARCH, GEMMA_PROMPTS, GEMMA_NEW_TOKENS))
    for arch, lens, new_tokens in runs:
        for name, n in _serve_full(arch, lens, new_tokens).items():
            launches[name] += n
    for arch in (*LM_ARCHS, GEMMA_ARCH):
        _reduced_card_vs_cpu(arch)
    return launches


# -- phase 7 ----------------------------------------------------------------

# 7a: the streaming cohort server, 20 rounds under a client trace: a
# diurnal day, a slow tier that misses the 3 s deadline, dropout and churn
STREAM_ROUNDS = 20
STREAM_COHORT = 64
STREAM_TRACE = dict(availability="diurnal", day_period_s=60.0,
                    tiers=(1.0, 6.0), dropout_hazard=0.05, p_join=0.3,
                    p_leave=0.01)
STREAM_DEADLINE_S = 3.0
# 7b: the frontend, 4 tenants of N clients (the first two on one table),
# 16 concurrent select threads a wave
TENANTS, SELECT_THREADS, WAVES = 4, 16, 3
# 7c: the paper-scale loop under chaos: a third of the clients on a tier
# that always misses the 3 s deadline, dropout and churn
LOOP_TRACE = dict(availability="diurnal", day_period_s=240.0,
                  avail_floor=0.4, avail_amplitude=0.6,
                  tiers=(1.0, 1.0, 6.0), dropout_hazard=0.1, p_join=0.3,
                  p_leave=0.05)
LOOP_ROUND = dict(deadline_s=3.0, reward_blend=0.5)
LOOP_ROUNDS = 3
SOLVER_THREAD = "repro-solver"   # the BackgroundSolver's thread names
JOIN_S = 120.0                   # every join, drain and close waits this


def _fused_by_thread():
    """{thread name: {kernel: launches}} of B1-B4 since the last reset."""
    from repro_torch.kernels import ops
    return {thread: {name: counts[name] for name in FUSED}
            for thread, counts in list(ops.THREAD_LAUNCHES.items())
            if any(counts[name] for name in FUSED)}


def _solver_launches(by_thread):
    return {name: sum(counts[name] for thread, counts in by_thread.items()
                      if thread.startswith(SOLVER_THREAD))
            for name in FUSED}


def _quantiles(seconds):
    import numpy as np
    ms = np.asarray(seconds) * 1e3
    return (f"median {np.median(ms):.3f} ms, p90 "
            f"{np.percentile(ms, 90):.3f} ms, max {ms.max():.3f} ms "
            f"over {len(ms)}")


def _fresh_library():
    """Unload the kernel libraries: the next launch loads them again, on
    whichever thread makes it.  Returns the list that names that thread.
    nvcc does not run again: phase 1 built these sources' hash."""
    import threading
    from repro_torch.kernels import _build

    lib = _build._Library()
    first = []
    get = lib.get

    def recording_get():
        if not first:
            first.append(threading.current_thread().name)
        return get()

    lib.get = recording_get
    _build.LIBRARY = lib
    return first


def _engine_log(engine):
    """Log every solve of ``engine`` in engine order: the table, the
    staged solve, and the thread, grad mode and stream (the engine
    device's current stream on that thread) it ran on."""
    import threading
    import torch

    log, lock = [], threading.Lock()
    prepare = engine._prepare

    def logged(embeds, fp, *, key, warm_ok):
        prep = prepare(embeds, fp, key=key, warm_ok=warm_ok)
        with lock:
            log.append(dict(
                table=embeds, prep=prep,
                thread=threading.current_thread().name,
                grad=torch.is_grad_enabled(),
                stream=torch.cuda.current_stream(engine.device).cuda_stream))
        return prep

    engine._prepare = logged
    return log


def phase7a(x, labels):
    """The streaming cohort server under a client trace; returns its
    B1-B4 launches."""
    import numpy as np
    import torch
    from repro_torch.cohort import CohortConfig, CohortEngine
    from repro_torch.fed.realism import (ClientTrace, RoundSpec, SimClock,
                                         TraceSpec)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CohortServer
    from repro_torch.streaming import StreamingSpec

    config = CohortConfig(num_clusters=K, use_pallas=True, num_landmarks=M)
    first_load = _fresh_library()
    server = CohortServer(N, D, policy="dqn", state_features="system",
                          seed=ENGINE_SEED, config=config,
                          streaming=StreamingSpec(max_stale_versions=None))
    solver = server._solver
    solves = _engine_log(server.engine)
    centers = np.random.default_rng(SEED).normal(
        size=(K, D)).astype(np.float32) * 6       # blobs()' first draw
    rng = np.random.default_rng(SEED + 7)
    trace = ClientTrace(N, TraceSpec(**STREAM_TRACE), seed=SEED)
    spec = RoundSpec(deadline_s=STREAM_DEADLINE_S)
    clock = SimClock()
    rows = []
    with plain_on_card_forbidden():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        server.update_embeddings(np.arange(N), x)
        # the cold start: the first select comes while the solver
        # thread's solve of the table is in flight
        deadline = time.monotonic() + JOIN_S
        while not any(name.startswith(SOLVER_THREAD)
                      for name in list(ops.THREAD_LAUNCHES)):
            if time.monotonic() > deadline or solver.stats["errors"]:
                raise AssertionError("the solver thread launched nothing")
            time.sleep(2e-4)
        for r in range(STREAM_ROUNDS):
            warm0 = server.stats()["served_warm"]
            ids, res = server.select_cohort(STREAM_COHORT)
            st = server.stats()
            rows.append(dict(warm=st["served_warm"] > warm0,
                             seconds=server.last_select_s,
                             version=st["streaming"]["served_version"],
                             table_version=st["table_version"],
                             source=res.source))
            out = trace.simulate_round(r, clock.now(), ids, spec)
            clock.advance(out.elapsed_s)
            useful = (float(np.mean(labels[out.completed] != 0))
                      if len(out.completed) else 0.0)
            server.observe_round(0.5 + 0.4 * useful, outcome=out)
            # the round's survivors drift; clients that join bring a
            # fresh row drawn from their own blob
            joined, _ = trace.churn_step(r + 1)
            moved = np.union1d(out.completed, joined)
            new = server.embeds[moved] + 0.01 * rng.normal(
                size=(len(moved), D)).astype(np.float32)
            fresh = np.isin(moved, joined)
            new[fresh] = centers[labels[moved[fresh]]] + rng.normal(
                size=(int(fresh.sum()), D)).astype(np.float32)
            server.update_embeddings(moved, new)
        if not solver.drain(timeout=JOIN_S):
            raise AssertionError("the background solver did not drain")
        _, last = server.select_cohort(STREAM_COHORT)   # the last warm
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: ops.LAUNCH_COUNTS[name] for name in FUSED}
        by_thread = _fused_by_thread()
    server.observe_round(0.5)
    stats = server.stats()
    errors = solver.stats["errors"]
    print(f"phase 7a: {STREAM_ROUNDS} rounds + the last warm select in "
          f"{wall:.3f} s; stats {json.dumps(stats, default=float)}")
    print(f"phase 7a: B1-B4 launches {json.dumps(launches)}; by thread "
          f"{json.dumps(by_thread)}; the libraries first loaded on "
          f"{first_load[:1]}")
    warm_s = [row["seconds"] for row in rows if row["warm"]]
    inline_s = [row["seconds"] for row in rows if not row["warm"]]
    print(f"phase 7a: warm-served selects: {_quantiles(warm_s)}; inline "
          f"(cold start) {[round(s * 1e3, 3) for s in inline_s]} ms")
    worker = [s for s in solves if s["thread"].startswith(SOLVER_THREAD)]
    print(f"phase 7a: {len(solves)} engine solves, {len(worker)} on the "
          f"solver thread (sources "
          f"{[s['prep'].result.source for s in solves]}): "
          f"{_quantiles([s['prep'].result.seconds for s in worker])}; "
          f"served versions {[row['version'] for row in rows]} of "
          f"{[row['table_version'] for row in rows]}")
    if errors != 0:
        raise AssertionError(f"{errors} background solves failed; the "
                             f"last:\n{solver.last_error}")
    if stats["warm_ahead"] <= 0:
        raise AssertionError("no background warm landed")
    if stats["forced_inline"] != 1:
        raise AssertionError(f"forced_inline {stats['forced_inline']}, "
                             f"expected 1 (the cold start)")
    if stats["served_warm"] < 15:
        raise AssertionError(f"served_warm {stats['served_warm']} < 15")
    versions = [row["version"] for row in rows]
    if any(a > b for a, b in zip(versions, versions[1:])):
        raise AssertionError(f"served versions went back: {versions}")
    if not first_load or not first_load[0].startswith(SOLVER_THREAD):
        raise AssertionError(f"the first launch was on {first_load[:1]}")
    solver_launches = _solver_launches(by_thread)
    if any(n <= 0 for n in solver_launches.values()):
        raise AssertionError(f"solver-thread launches {solver_launches}")
    # the engine's device is pinned when the server is built, so the
    # worker's tensors land on it whatever that thread's current device
    if server.device != torch.device("cuda", torch.cuda.current_device()):
        raise AssertionError(f"the server's device is {server.device}")
    default = torch.cuda.default_stream(server.device).cuda_stream
    for s in worker:
        if s["grad"] or s["stream"] != default:
            raise AssertionError(f"a background solve ran with grad "
                                 f"{s['grad']} on stream {s['stream']}")
    # the last warm result against an inline replay: a second engine with
    # the same seed solves the same snapshots from the last cold solve on
    end = next(i for i, s in enumerate(solves) if s["prep"].result is last)
    start = max(i for i in range(end + 1) if not solves[i]["prep"].warm)
    again = CohortEngine(config, seed=ENGINE_SEED)
    for s in solves[start:end + 1]:
        res = again.select(s["table"])
        if (res.source != s["prep"].result.source
                or not np.array_equal(res.assign, s["prep"].result.assign)):
            raise AssertionError("an inline replay of a background solve "
                                 "gives other assignments")
    print(f"phase 7a: the last warm result ({last.source}, solve "
          f"{end + 1} of {len(solves)}) equals an inline replay of solves "
          f"{start + 1}-{end + 1} bit for bit")
    cold = solves[0]["prep"]
    p = purity(cold.result.assign, labels)
    print(f"phase 7a: cold purity {p:.5f} (limit 0.95), last warm purity "
          f"{purity(last.assign, labels):.5f}")
    if cold.warm or p < 0.95:
        raise AssertionError(f"cold purity {p:.4f} < 0.95")
    (_, res), _, _ = profile_device(
        "7a", "warm-served select",
        lambda: server.select_cohort(STREAM_COHORT))
    server.observe_round(0.5)
    print(f"phase 7a: the profiled select was served from version "
          f"{server.stats()['streaming']['served_version']} ({res.source})")
    server.close(timeout=JOIN_S)
    if any(t.is_alive() for t in solver._threads):
        raise AssertionError("the solver thread outlived close()")
    return launches


def _lone_partition(config, seed, table, cache):
    """The partition a lone CohortServer with ``seed`` gives ``table``."""
    import numpy as np
    from repro_torch.launch.serve import CohortServer

    key = (seed, id(table))
    if key not in cache:
        lone = CohortServer(N, D, seed=seed, config=config)
        lone.update_embeddings(np.arange(N), table)
        cache[key] = lone.select_cohort(STREAM_COHORT)[1].assign
    return cache[key]


def _frontend_waves(fe, waves, label):
    """``waves`` waves of SELECT_THREADS concurrent selects over the
    tenants; returns (the batches each tenant server ran, selects/s of
    each wave)."""
    import threading

    batches, lock = [], threading.Lock()
    for name in fe.tenant_names:
        server = fe.tenant(name)

        def recording(*args, _run=server.select_cohorts, _name=name, **kw):
            out = _run(*args, **kw)
            with lock:
                batches.append((_name, [ids for ids, _ in out]))
            return out

        server.select_cohorts = recording
    rates = []
    for wave in range(waves):
        barrier = threading.Barrier(SELECT_THREADS)
        errors = []

        def select(i):
            try:
                barrier.wait(timeout=JOIN_S)
                fe.select_cohort(fe.tenant_names[i % len(fe.tenant_names)],
                                 STREAM_COHORT)
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=select, args=(i,),
                                    name=f"select-{label}-{wave}-{i}")
                   for i in range(SELECT_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        dt = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"wave {wave}: {errors or 'a select hung'}")
        rates.append(SELECT_THREADS / dt)
        for name in fe.tenant_names:
            fe.observe_round(name, 0.6)
    for name, cohorts in batches:
        flat = [int(i) for ids in cohorts for i in ids]
        if len(flat) != len(set(flat)):
            raise AssertionError(f"{name}: a batch served a client twice")
    return batches, rates


def phase7b(x):
    """The multi-tenant frontend, with a shared streaming solver and
    without; returns its B1-B4 launches."""
    import numpy as np
    import torch
    from repro_torch.cohort import CohortConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.frontend import make_demo_frontend
    from repro_torch.streaming import StreamingSpec

    config = CohortConfig(num_clusters=K, use_pallas=True, num_landmarks=M)
    tables = [x, x, blobs(np.random.default_rng(SEED + 11))[0],
              blobs(np.random.default_rng(SEED + 12))[0]]
    seeds = [ENGINE_SEED + i for i in range(TENANTS)]
    launches = dict.fromkeys(FUSED, 0)
    lone = {}
    for streaming in (StreamingSpec(), None):
        label = "streaming" if streaming else "inline"
        fe = make_demo_frontend(TENANTS, N, D, config=config,
                                seed=ENGINE_SEED, policy="dqn",
                                streaming=streaming)
        with plain_on_card_forbidden():
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            for name, table in zip(fe.tenant_names, tables):
                fe.update_embeddings(name, np.arange(N), table)
            if streaming and not fe._solver.drain(timeout=JOIN_S):
                raise AssertionError("the shared solver did not drain")
            warmed = time.perf_counter() - t0
            batches, rates = _frontend_waves(
                fe, WAVES if streaming else 1, label)
            torch.cuda.synchronize()
            for name in FUSED:
                launches[name] += ops.LAUNCH_COUNTS[name]
            by_thread = _fused_by_thread()
        agg = fe.stats()["frontend"]
        per = fe.stats()["tenants"]
        solver = fe._solver
        errors = 0 if solver is None else solver.stats["errors"]
        print(f"phase 7b: {label}: {TENANTS} tenants of {N} clients, tables "
              f"in {warmed:.3f} s; waves of {SELECT_THREADS} selects: "
              f"{', '.join(f'{r:.1f}' for r in rates)} selects/s; batch "
              f"factor {agg['batch_factor']:.3f} ({agg['requests']} "
              f"requests in {agg['batches']} batches, {len(batches)} "
              f"recorded); solves {agg['solves']}, dedupe hits "
              f"{agg['dedupe_hit']}, served warm {agg['served_warm']}, "
              f"forced inline {agg['forced_inline']}, solver errors "
              f"{errors}")
        print(f"phase 7b: {label}: B1-B4 launches by thread "
              f"{json.dumps(by_thread)}")
        if errors:
            raise AssertionError(f"{errors} background solves failed; the "
                                 f"last:\n{solver.last_error}")
        for i, name in enumerate(fe.tenant_names):
            st = per[name]
            if st["engine"]["solves"] + st["dedupe_hit"] != 1:
                raise AssertionError(f"{name}: {st['engine']['solves']} "
                                     f"solves, {st['dedupe_hit']} adopted")
            # an adopted solve is its leader's, seeded with the leader's
            # seed (the dedupe key is the table and the config)
            seed = seeds[0] if st["dedupe_hit"] else seeds[i]
            got = fe.tenant(name).engine.state.result.assign
            if not same_partition(
                    got, _lone_partition(config, seed, tables[i], lone)):
                raise AssertionError(f"{name}: partition differs from a "
                                     f"lone server with seed {seed}")
        if streaming:
            if per[fe.tenant_names[1]]["dedupe_hit"] < 1:
                raise AssertionError("the tenants with one table did not "
                                     "share a solve")
            if agg["forced_inline"] or not _solver_launches(by_thread)[
                    "nystrom_gram"]:
                raise AssertionError("the streaming frontend solved inline")
        else:
            callers = {name: sum(counts[name]
                                 for t, counts in by_thread.items()
                                 if t.startswith("select-"))
                       for name in FUSED}
            if any(n <= 0 for n in callers.values()):
                raise AssertionError(f"caller-thread launches {callers}")
        solver = fe._solver
        fe.close(timeout=JOIN_S)
        if solver is not None and any(t.is_alive()
                                      for t in solver._threads):
            raise AssertionError("the shared solver outlived close()")
    print(f"phase 7b: every tenant's partition equals a lone server's "
          f"({len(lone)} lone solves)")
    return launches


def phase7c():
    """The paper-scale loop under client realism; returns its B7
    launches."""
    import numpy as np
    import torch
    from repro_torch.fed.realism import ClientTrace, RoundSpec, TraceSpec
    from repro_torch.fed.rounds import FederatedRunner, RunnerConfig
    from repro_torch.kernels import ops

    cfg = RunnerConfig(**PAPER_FL)
    runner = FederatedRunner(cfg)
    runner._pool_noise = decisive_pool_noise(runner)
    runner.attach_trace(ClientTrace(cfg.num_clients, TraceSpec(**LOOP_TRACE),
                                    seed=cfg.seed), RoundSpec(**LOOP_ROUND))
    with plain_on_card_forbidden():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        runner.warmup()
        torch.cuda.synchronize()
        print(f"phase 7c: warm-up of {cfg.num_clients} clients "
              f"{time.perf_counter() - t0:.3f} s")
        for _ in range(LOOP_ROUNDS):
            before = ops.LAUNCH_COUNTS["pairwise_sq_dists"]
            t0 = time.perf_counter()
            res = runner.run_round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b7 = ops.LAUNCH_COUNTS["pairwise_sq_dists"] - before
            out = res.outcome
            print(f"phase 7c: round {res.round_idx}: host {wall:.4f} s, "
                  f"simulated {res.sim_seconds:.4f} s; acc "
                  f"{res.accuracy:.4f} loss {res.loss:.4f} reward "
                  f"{res.reward:+.3f}; {res.num_completed} completed "
                  f"{out.completed.tolist()}, {res.num_dropped} dropped "
                  f"{out.reasons}, {res.num_stragglers} stragglers; "
                  f"{b7} B7 launches")
            finite = all(bool(torch.isfinite(v).all())
                         for v in runner.global_params.values())
            if (res.num_completed + res.num_dropped != len(res.selected)
                    or res.sim_seconds != out.elapsed_s or not finite
                    or not np.isfinite(res.loss) or b7 < 1):
                raise AssertionError(f"round {res.round_idx} failed its "
                                     f"checks")
        launches = ops.LAUNCH_COUNTS["pairwise_sq_dists"]
    print(f"phase 7c: {launches} B7 launches; simulated seconds "
          f"{runner.sim_clock.now():.4f}")
    return launches


def phase7(x, labels):
    """Streaming, the frontend and client realism on the card; returns
    {kernel: launches}."""
    launches = phase7a(x, labels)
    for name, n in phase7b(x).items():
        launches[name] += n
    launches["pairwise_sq_dists"] = phase7c()
    return launches


# -- phase 8 ----------------------------------------------------------------

def phase8a(x, labels):
    """The mesh route: ``CohortEngine(method="sharded", mesh=...)`` at the
    path shape and at N + 3 rows, fused at f32, bf16 and int8, on
    (cuda:0,) * D for D in SHARD_COUNTS (and every visible card when
    there are more than one).  Returns the fused kernels' launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.cohort import CohortConfig, CohortEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_cohort_mesh

    cards = torch.cuda.device_count()
    meshes = [(torch.device("cuda", 0),) * d for d in SHARD_COUNTS]
    if cards > 1:
        meshes.append(make_cohort_mesh())
    print(f"phase 8a: {cards} visible CUDA device(s); meshes "
          f"{[[str(d) for d in mesh] for mesh in meshes]}")
    padded, padded_labels = blobs(np.random.default_rng(SEED + 13), n=N + 3)
    launches = dict.fromkeys(FUSED, 0)
    with plain_on_card_forbidden():
        for table, truth in ((x, labels), (padded, padded_labels)):
            for dtype in DTYPES:
                config = CohortConfig(num_clusters=K, method="sharded",
                                      use_pallas=True, num_landmarks=M,
                                      affinity_dtype=dtype)
                single = CohortEngine(
                    dataclasses.replace(config, method="nystrom"),
                    seed=ENGINE_SEED).select(table)
                one = None
                for mesh in meshes:
                    shards = len(mesh)
                    runs = []
                    for _ in range(2):
                        ops.reset_launch_counts()
                        runs.append(CohortEngine(
                            config, seed=ENGINE_SEED, mesh=mesh).select(table))
                        torch.cuda.synchronize()
                        counts = {n: ops.LAUNCH_COUNTS[n] for n in FUSED}
                        want = {n: 1 if n == FUSED[0] else shards
                                for n in FUSED}
                        if counts != want:
                            raise AssertionError(
                                f"D={shards}: launches {counts}, expected "
                                f"{want}")
                        for n, c in counts.items():
                            launches[n] += c
                    res, again = runs
                    label = f"N={len(table)} {dtype} D={shards}"
                    if res.method != "sharded" or res.source != "cold":
                        raise AssertionError(f"{label}: {res.method}/"
                                             f"{res.source}")
                    if not (np.array_equal(res.embedding, again.embedding)
                            and np.array_equal(res.evals, again.evals)
                            and np.array_equal(res.assign, again.assign)):
                        raise AssertionError(f"{label}: a re-solve is not "
                                             f"bit-identical")
                    if shards == 1:
                        one = res
                        if not (np.array_equal(res.embedding,
                                               single.embedding)
                                and np.array_equal(res.evals, single.evals)):
                            raise AssertionError(
                                f"{label}: not nystrom_from_landmarks' "
                                f"result bit for bit")
                    ev_err = float(np.abs(res.evals[:K]
                                          - one.evals[:K]).max())
                    p = purity(res.assign, truth)
                    same = same_partition(res.assign, one.assign)
                    print(f"phase 8a: {label}: select {res.seconds:.4f} s, "
                          f"leading evals vs D=1 {ev_err:.3e} (limit "
                          f"{LIMIT_SHARD_EVALS:.0e}), purity {p:.5f}, "
                          f"partition = D=1's: {same}; re-solve "
                          f"bit-identical"
                          + ("; = the single-device solve bit for bit"
                             if shards == 1 else ""))
                    if ev_err > LIMIT_SHARD_EVALS:
                        raise AssertionError(f"{label}: evals differ by "
                                             f"{ev_err:.3e}")
                    if p < 0.95:
                        raise AssertionError(f"{label}: purity {p:.4f}")
                    if not same:
                        raise AssertionError(f"{label}: partition differs "
                                             f"from D=1's")
    print(f"phase 8a: B1-B4 launches {json.dumps(launches)}")
    return launches


@contextlib.contextmanager
def moe_ranges():
    """Name the MoE layers' work for the profiler: ``record_function``
    ranges around each MoE layer, its routing and its expert GEMMs, for
    the duration of the block only."""
    import torch
    from repro_torch.models import moe as MOE

    saved = {name: getattr(MOE, name)
             for name in ("_moe_shard", "route", "_experts")}
    labels = {"_moe_shard": "moe", "route": "moe.route",
              "_experts": "moe.experts"}

    def ranged(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(labels[name]):
                return fn(*args, **kwargs)
        return wrapped

    for name, fn in saved.items():
        setattr(MOE, name, ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(MOE, name, fn)


def phase8b():
    """The MoE server: moonshot at full width on the card, then the three
    MoE archs reduced, card against CPU.  Returns {kernel: launches}: the
    full-width serving run's and reduced jamba's (B9 and B10 beside an
    MoE FFN)."""
    import torch

    with moe_ranges():
        launches = _serve_full(MOE_ARCH, phase="8b", groups=MOE_GROUPS)
    for arch in MOE_REDUCED:
        counts = _reduced_card_vs_cpu(arch, phase="8b")
        if arch.startswith("jamba"):
            for name, n in counts.items():
                launches[name] += n
    torch.cuda.empty_cache()
    return launches


def _mla_cut():
    """deepseek-v3-671b's config cut to MLA_LAYERS layers; prints the
    cut."""
    import dataclasses
    from repro_torch.configs import get_config

    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, num_layers=MLA_LAYERS)
    print(f"phase 9: {MLA_ARCH} reduced: " + json.dumps({
        "num_layers": [full.num_layers, cfg.num_layers],
        "param_count": [full.param_count(), cfg.param_count()],
        "why": "the 61 layers do not fit one card; the cut keeps the 3 "
               "dense MLA layers, the first MoE layer and the MTP head"}))
    return cfg


def _mla_block():
    """One full-width MLA block in f32: the card's expanded prefill (B9)
    and absorbed decode against the CPU's, and the absorbed decode
    against the expanded prefill one token longer.  Returns the B9
    launches of the card's prefill."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import mla as MLA
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=1,
                              param_dtype="float32",
                              compute_dtype="float32")
    params = MLA.mla_init(torch.Generator().manual_seed(LM_SEED), cfg,
                          device="cpu")
    on_card = T.params_to(params, "cuda")
    S = MLA_BLOCK_S
    x = torch.tensor(np.random.default_rng(LM_SEED + 3).normal(
        size=(1, S + 1, cfg.d_model)), dtype=torch.float32)
    print(f"phase 9: MLA block: {_numel(params) / 1e9:.4f}e9 parameters "
          f"in f32 ({cfg.num_heads} heads, q_lora {cfg.mla.q_lora_rank}, "
          f"kv_lora {cfg.mla.kv_lora_rank}, d_model {cfg.d_model})")
    outs = {}
    for dev, p in (("cuda", on_card), ("cpu", params)):
        cache = MLA.init_mla_cache(cfg, 1, LM_MAX_SEQ, device=dev)
        guard = plain_on_card_forbidden() if dev == "cuda" \
            else contextlib.nullcontext()
        with guard, ops.use_pallas_scoped(True):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            pre, _ = MLA.mla_attention(
                p, x[:, :S].to(dev), cfg,
                positions=torch.arange(S, device=dev), cache=cache,
                cache_pos=0)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = ops.LAUNCH_COUNTS["flash_attention"]
            t1 = time.perf_counter()
            step, _ = MLA.mla_attention(
                p, x[:, S:].to(dev), cfg,
                positions=S + torch.arange(1, device=dev), cache=cache,
                cache_pos=S)
            if dev == "cuda":
                torch.cuda.synchronize()
                expanded, _ = MLA.mla_attention(
                    p, x.to(dev), cfg,
                    positions=torch.arange(S + 1, device=dev))
                outs["expanded"] = expanded[:, -1].cpu()
            t2 = time.perf_counter()
        outs[dev] = (pre.cpu(), step.cpu())
        print(f"phase 9: MLA block on the {dev}: expanded prefill S={S} "
              f"{(t1 - t0) * 1e3:.3f} ms, absorbed decode step at "
              f"position {S} {(t2 - t1) * 1e3:.3f} ms (one call each"
              + ("; the second includes the S + 1 expanded prefill)"
                 if dev == "cuda" else ")"))
    if launches != 1:
        raise AssertionError(f"MLA block: {launches} B9 launches, "
                             f"expected 1")
    for name, got, want in (("prefill", outs["cuda"][0], outs["cpu"][0]),
                            ("decode", outs["cuda"][1], outs["cpu"][1]),
                            ("absorbed vs expanded", outs["cuda"][1][:, 0],
                             outs["expanded"])):
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"MLA block {name}: malformed output")
        err = float((got - want).abs().max() / want.abs().max())
        print(f"phase 9: MLA block {name}: {err:.3e} of the largest "
              f"|entry| (limit {LIMIT_MLA_REL:.0e})")
        if err > LIMIT_MLA_REL:
            raise AssertionError(f"MLA block {name}: error {err:.3e}")
    return launches


def _vlm_prefix_prefill(server):
    """One prefill on the card of VLM_PREFIX prefix embeddings (drawn
    from the seed) and VLM_TEXT tokens through ``server``'s weights."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = server.cfg
    rng = np.random.default_rng(LM_SEED + 4)
    batch = {"tokens": torch.tensor(rng.integers(
                 0, cfg.vocab_size, (1, VLM_TEXT)), device="cuda"),
             "prefix_embeds": torch.tensor(
                 rng.normal(size=(1, VLM_PREFIX, cfg.d_model)) * 0.02,
                 dtype=torch.float32, device="cuda")}
    caches = T.init_lm_cache(cfg, 1, LM_MAX_SEQ, device="cuda")

    def prefill():
        return T.lm_prefill(server.params, cfg, batch, caches)[0]

    with plain_on_card_forbidden(), ops.use_pallas_scoped(True), \
            flash_shapes() as shapes:
        ops.reset_launch_counts()
        logits = prefill()
        torch.cuda.synchronize()
        n = ops.LAUNCH_COUNTS["flash_attention"]
        ms = time_ms(prefill, reps=5)
    print(f"phase 9: {VLM_ARCH}: prefill of {VLM_PREFIX} prefix embeddings "
          f"and {VLM_TEXT} tokens {ms:.3f} ms (median of 5); {n} B9 "
          f"launches at {sorted(set(shapes))}")
    if n != cfg.num_layers:
        raise AssertionError(f"{VLM_ARCH}: {n} B9 launches in the prefix "
                             f"prefill, expected {cfg.num_layers}")
    if logits.shape != (1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{VLM_ARCH}: malformed prefix prefill logits")


def phase9():
    """MLA and prefix embeddings: deepseek-v3 (depth cut) and
    internvl2-26b served at full width, one full-width MLA block card vs
    CPU, both archs reduced card vs CPU.  Returns {kernel: launches}."""
    import torch

    launches = _serve_full(MLA_ARCH, phase="9", cfg=_mla_cut(),
                           flash_shape=(192, 128, 128, 128))
    launches["flash_attention"] += _mla_block()
    torch.cuda.empty_cache()
    for name, n in _serve_full(VLM_ARCH, phase="9",
                               flash_shape=(128, 128, 48, 8),
                               after=_vlm_prefix_prefill).items():
        launches[name] += n
    for arch in (MLA_ARCH, VLM_ARCH):
        for name, n in _reduced_card_vs_cpu(arch, phase="9").items():
            launches[name] += n
    return launches


# -- phase 10 ---------------------------------------------------------------

def _greedy(decode, params, caches, logits, start, steps):
    """``steps`` greedy decode steps from the prefill's ``logits``, the
    argmax taken on the device.  Returns (the tokens fed (B, steps), the
    logits of every step, caches)."""
    import torch

    fed, seq = [], []
    tok = logits.argmax(-1, keepdim=True)
    for i in range(steps):
        fed.append(tok)
        logits, caches = decode(params, caches, tok, start + i)
        seq.append(logits)
        tok = logits.argmax(-1, keepdim=True)
    return torch.cat(fed, 1), seq, caches


def _encdec_full():
    """(a): seamless-m4t-medium at full width and depth in bf16 through
    the port's step builders.  Returns the B9 launches of the prefill."""
    import collections

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ED

    cfg = get_config(ENCDEC_ARCH)
    B, P, F = ENCDEC_BATCH, ENCDEC_PROMPT, cfg.encoder_seq_len
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ED.init_encdec(torch.Generator(device="cuda").manual_seed(
        LM_SEED), cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 10: {ENCDEC_ARCH}: {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters in {cfg.param_dtype}, {cfg.num_encoder_layers} "
          f"encoder + {cfg.num_layers} decoder layers, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s ({_numel(params) / 1e9:.3f}e9 "
          f"in the tree)")
    shape = ShapeConfig("encdec_smoke", ENCDEC_SEQ, B, "prefill")
    prefill = steps.make_prefill_step(cfg, shape)
    decode = steps.make_decode_step(cfg, shape)
    rng = np.random.default_rng(LM_SEED + 5)
    batch = {"src_embeds": torch.tensor(
                 rng.normal(size=(B, F, cfg.d_model)),
                 dtype=torch.bfloat16, device="cuda"),
             "tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                                    device="cuda")}
    print(f"phase 10: {ENCDEC_ARCH}: batch {B} (lockstep), source {F} "
          f"frames, prompt {P} tokens, self cache {ENCDEC_SEQ} rows, "
          f"{ENCDEC_NEW_TOKENS} greedy decode steps")
    with plain_on_card_forbidden(), ops.use_pallas_scoped(True):
        with flash_shapes(roles=True) as calls:
            ops.reset_launch_counts()
            logits, caches = prefill(params, batch)
            torch.cuda.synchronize()
            launches = ops.LAUNCH_COUNTS["flash_attention"]
            roles = collections.Counter(calls)
            first = (logits.clone(),
                     [{k: t[:, :P].clone() for k, t in c.items()}
                      for c in caches["self"]], caches["cross"])
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            fed, seq, caches = _greedy(decode, params, caches, logits, P,
                                       ENCDEC_NEW_TOKENS)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            decode_launches = ops.LAUNCH_COUNTS["flash_attention"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        enc_ms = time_ms(lambda: ED.encode(params, cfg, batch["src_embeds"]),
                         reps=5)
        pre_ms = time_ms(lambda: prefill(params, batch), reps=5)
        again, again_caches = prefill(params, batch)
        torch.cuda.synchronize()
        same = torch.equal(again, first[0]) and all(
            torch.equal(c[k][:, :P], f[k])
            for c, f in zip(again_caches["self"], first[1]) for k in f) \
            and all(torch.equal(c[k], f[k])
                    for c, f in zip(again_caches["cross"], first[2])
                    for k in f)
        profile_device("10", f"{ENCDEC_ARCH} prefill (batch {B}, source "
                       f"{F}, prompt {P})", lambda: prefill(params, batch),
                       host_top=6)
        profile_device("10", f"{ENCDEC_ARCH} decode step (batch {B})",
                       lambda: decode(params, again_caches, fed[:, :1], P),
                       host_top=6)
    dh, dv, H, K = ENCDEC_FLASH_SHAPE
    want = {(dh, dv, H, K, F, F, False): cfg.num_encoder_layers,
            (dh, dv, H, K, P, ENCDEC_SEQ, True): cfg.num_layers,
            (dh, dv, H, K, P, F, False): cfg.num_layers}
    print(f"phase 10: {ENCDEC_ARCH}: peak device memory {peak:.2f} GiB; "
          f"encode {enc_ms:.3f} ms, prefill (encode included) {pre_ms:.3f} "
          f"ms (median of 5); decode {B * ENCDEC_NEW_TOKENS / decode_s:.1f} "
          f"tok/s ({ENCDEC_NEW_TOKENS} steps of batch {B} in "
          f"{decode_s * 1e3:.3f} ms)")
    print(f"phase 10: {ENCDEC_ARCH}: B9 launches: prefill {launches} "
          f"({sum(n for r, n in roles.items() if not r[6])} non-causal), "
          f"{ENCDEC_NEW_TOKENS} decode steps {decode_launches}; (dh, dv, H, "
          f"K, S, T, causal) of the prefill's: {sorted(roles.items())}")
    print(f"phase 10: {ENCDEC_ARCH}: row 0 generated "
          f"{fed[0, :8].tolist()}; repeat prefill bit-identical "
          f"(logits and caches): {same}")
    if launches != sum(want.values()) or roles != want:
        raise AssertionError(f"{ENCDEC_ARCH}: B9 launches {dict(roles)}, "
                             f"expected {want}")
    if decode_launches:
        raise AssertionError(f"{ENCDEC_ARCH}: {decode_launches} B9 launches "
                             f"in decode")
    if first[0].shape != (B, cfg.vocab_size) or not all(
            torch.isfinite(t).all() for t in (first[0], *seq)) or \
            not bool(((fed >= 0) & (fed < cfg.vocab_size)).all()):
        raise AssertionError(f"{ENCDEC_ARCH}: malformed logits or tokens")
    if not same:
        raise AssertionError(f"{ENCDEC_ARCH}: a repeat prefill differs")
    del params, caches, again_caches, first
    torch.cuda.empty_cache()
    return launches


def _encdec_card_vs_cpu(cfg, label, frames, prompt, steps_n):
    """One row through the step builders on the card and on the CPU, the
    same weights (drawn on the CPU): prefill and decode logits within
    LIMIT_LOGIT_REL of the largest entry and the same greedy tokens; then
    the card's first decode step against teacher forcing (``_decoder``
    over the prompt and that token).  Returns the card prefill's B9
    launches."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on")
    params = ED.init_encdec(torch.Generator().manual_seed(LM_SEED), cfg,
                            device="cpu")
    on_card = T.params_to(params, "cuda")
    rng = np.random.default_rng(LM_SEED + 6)
    src = torch.tensor(rng.normal(size=(1, frames, cfg.d_model)),
                       dtype=torch.float32)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, prompt)))
    shape = ShapeConfig("encdec_smoke", prompt + steps_n, 1, "prefill")
    prefill = steps.make_prefill_step(cfg, shape)
    decode = steps.make_decode_step(cfg, shape)
    out = {}
    for where, dev, p in (("card", "cuda", on_card), ("CPU", "cpu", params)):
        guard = plain_on_card_forbidden() if where == "card" \
            else contextlib.nullcontext()
        with guard, ops.use_pallas_scoped(True):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, caches = prefill(p, {"src_embeds": src.to(dev),
                                         "tokens": toks.to(dev)})
            if where == "card":
                torch.cuda.synchronize()
                launches = ops.LAUNCH_COUNTS["flash_attention"]
            t1 = time.perf_counter()
            fed, seq, _ = _greedy(decode, p, caches, logits, prompt, steps_n)
            t2 = time.perf_counter()
        out[where] = ([logits.cpu()] + [x.cpu() for x in seq], fed.cpu())
        print(f"phase 10: {label} on the {where}: prefill "
              f"{(t1 - t0) * 1e3:.3f} ms, {steps_n} decode steps "
              f"{(t2 - t1) * 1e3:.3f} ms (one call each)")
    err = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(out["card"][0], out["CPU"][0]))
    same = torch.equal(out["card"][1], out["CPU"][1])
    with plain_on_card_forbidden(), ops.use_pallas_scoped(True):
        src_c = src.to("cuda")
        ids = torch.cat([toks, out["card"][1][:, :1]], 1).to("cuda")
        h = L.embed(on_card["embed"], ids).to(L.dtype_of(cfg.compute_dtype))
        full, _ = ED._decoder(on_card, cfg, h, ED.encode(on_card, cfg, src_c),
                              positions=torch.arange(prompt + 1,
                                                     device="cuda"))
        forced = T.lm_logits(on_card, cfg, full[:, -1:])[:, 0].cpu()
    step = out["card"][0][1]
    tf_err = float((step - forced).abs().max() / forced.abs().max())
    print(f"phase 10: {label}: prefill and {steps_n} decode logits card vs "
          f"CPU {err:.3e} of max |logit| (limit {LIMIT_LOGIT_REL:.0e}); the "
          f"same greedy tokens: {same} ({out['card'][1][0].tolist()}); the "
          f"card's first decode step vs teacher forcing over {prompt + 1} "
          f"tokens {tf_err:.3e}; {launches} B9 launches a card prefill")
    if err > LIMIT_LOGIT_REL or tf_err > LIMIT_LOGIT_REL or not same:
        raise AssertionError(f"{label}: card differs from the CPU or from "
                             f"teacher forcing ({err:.3e}, {tf_err:.3e}, "
                             f"same tokens {same})")
    want = cfg.num_encoder_layers + 2 * cfg.num_layers
    if launches != want:
        raise AssertionError(f"{label}: {launches} B9 launches a prefill, "
                             f"expected {want}")
    return launches


def phase10():
    """The encoder-decoder: seamless-m4t-medium at full width in bf16,
    cut to 2 + 2 layers in f32 and reduced, card against CPU; reduced
    through ``Server`` too.  Returns the B9 launches."""
    import dataclasses

    from repro_torch.configs import get_config

    launches = _encdec_full()
    full = get_config(ENCDEC_ARCH)
    cut = dataclasses.replace(full, num_layers=ENCDEC_CUT_LAYERS,
                              num_encoder_layers=ENCDEC_CUT_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    print(f"phase 10: {ENCDEC_ARCH} reduced: " + json.dumps({
        "num_layers": [full.num_layers, cut.num_layers],
        "num_encoder_layers": [full.num_encoder_layers,
                               cut.num_encoder_layers],
        "dtype": [full.param_dtype, cut.param_dtype],
        "param_count": [full.param_count(), cut.param_count()],
        "why": "f32 card against CPU at full width: the CPU's time bounds "
               "the depth"}))
    launches += _encdec_card_vs_cpu(cut, f"{ENCDEC_ARCH} f32 2 + 2 layers",
                                    full.encoder_seq_len, ENCDEC_PROMPT,
                                    ENCDEC_CUT_STEPS)
    small = full.reduced()
    launches += _encdec_card_vs_cpu(small, f"reduced {ENCDEC_ARCH}", 24, 13,
                                    4)
    launches += _reduced_card_vs_cpu(ENCDEC_ARCH, phase="10")[
        "flash_attention"]
    return launches


def _train_batch(cfg, batch, rng, dev, dtype):
    """``batch`` plus the encoder-decoder's frames (drawn from ``rng``,
    where the launcher feeds zeros, so the encoder trains too) or a
    VLM's prefix embeddings."""
    import torch

    B, S = batch["tokens"].shape
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = torch.tensor(
            rng.normal(size=(B, S, cfg.d_model)), dtype=dtype, device=dev)
    elif cfg.num_prefix_embeds:
        batch["prefix_embeds"] = torch.tensor(
            rng.normal(size=(B, cfg.num_prefix_embeds, cfg.d_model)),
            dtype=dtype, device=dev)
    return batch


@contextlib.contextmanager
def train_ranges(cfg):
    """``record_function`` ranges around the loss's forward, the clip and
    the optimizer update of a train step built inside the block."""
    import torch
    from repro_torch.launch import steps

    def ranged(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    mod = steps.ED if cfg.is_encoder_decoder else steps.T
    attr = "encdec_train_loss" if cfg.is_encoder_decoder else \
        "lm_train_loss"
    saved = (getattr(mod, attr), steps.clip_by_global_norm)
    setattr(mod, attr, ranged("train.loss", saved[0]))
    steps.clip_by_global_norm = ranged("train.clip", saved[1])
    try:
        yield lambda opt: type(opt)(opt.init,
                                    ranged("train.update", opt.update))
    finally:
        setattr(mod, attr, saved[0])
        steps.clip_by_global_norm = saved[1]


def _train_full(arch):
    """(a), (b): ``arch`` at full width and depth in bf16, the launcher's
    optimizer and batch, TRAIN_STEPS steps timed and one profiled, with
    the kernels on.  Returns the kernel launches of the steps and the
    losses."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenDataConfig, make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init = ED.init_encdec if cfg.is_encoder_decoder else T.init_lm
    params = init(torch.Generator(device="cuda").manual_seed(LM_SEED), cfg,
                  device="cuda")
    shape = ShapeConfig("custom_train", TRAIN_SEQ, TRAIN_BATCH, "train",
                        TRAIN_MICRO)
    G = steps.num_microbatches(cfg, shape)
    opt = steps.make_optimizer(cfg, TRAIN_STEPS)
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    print(f"phase 11: {arch}: {_numel(params) / 1e9:.3f}e9 parameters in "
          f"{cfg.param_dtype}, AdamW moments in "
          f"{opt_state['m']['embed']['w'].dtype}; global batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {G} microbatches; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    data = make_batch_iterator(
        TokenDataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=LM_SEED), device="cuda",
        num_batches=TRAIN_STEPS + 1)
    rng = np.random.default_rng(LM_SEED + 11)
    # bf16 weights move only where the warm-up's small steps cross half
    # an ulp: count the changed entries of two leaves (the step updates
    # them in place)
    first = (params["decoder"]["blocks"] if cfg.is_encoder_decoder
             else params["layers"])[0]
    watched = {"embed": params["embed"]["w"][:4096],
               "layer 0 ffn down": first["ffn"]["down"]["w"]}
    probe = {name: t.clone() for name, t in watched.items()}
    times, losses, norms = [], [], []
    with ops.use_pallas_scoped(True), train_ranges(cfg) as ranged:
        step_fn = steps.make_train_step(cfg, shape, ranged(opt))
        ops.reset_launch_counts()
        for step, batch in enumerate(data):
            batch = _train_batch(cfg, batch, rng, "cuda", torch.bfloat16)
            if step == TRAIN_STEPS:
                (params, opt_state, m), wall, busy = profile_device(
                    "11", f"{arch} train step (batch {TRAIN_BATCH} x "
                    f"{TRAIN_SEQ}, G {G})",
                    lambda: step_fn(params, opt_state, step, batch),
                    host_top=6, groups=TRAIN_GROUPS)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt_state, m = step_fn(params, opt_state, step,
                                               batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(times[1:])
    moved = {name: float((t != probe[name]).float().mean())
             for name, t in watched.items()}
    print(f"phase 11: {arch}: losses {[round(x, 4) for x in losses]}, "
          f"grad norms {[round(x, 4) for x in norms]}")
    print(f"phase 11: {arch}: step {step_ms:.3f} ms (host clock ending in "
          f"a synchronize, median of steps 2-{TRAIN_STEPS}; all "
          f"{[round(t, 3) for t in times]}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tok/s; peak "
          f"device memory {peak:.2f} GiB; profiled step wall {wall:.3f} ms,"
          f" busy {busy:.3f} ms ({busy / step_ms:.4f} of the unprofiled "
          f"median step{'' if busy else '; device time not measured'}); share of entries moved {moved}; kernel "
          f"launches in {TRAIN_STEPS + 1} steps "
          f"{ {k: n for k, n in launches.items() if n} or 0}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"{arch}: a loss or grad norm is not finite")
    if not all(moved.values()):
        raise AssertionError(f"{arch}: the parameters did not move")
    if sum(launches.values()):
        raise AssertionError(f"{arch}: training launched kernels "
                             f"{launches}")
    del params, opt_state, first, watched, probe, step_fn, m
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses


def nudge_one_ulp(params, seed):
    """Move every parameter entry one ulp up or down (a seeded coin)."""
    import torch
    from repro_torch.tree import leaves

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in leaves(params):
            up = (torch.rand(p.shape, generator=g) < 0.5).to(p.device)
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf,
                                                   -torch.inf)))


def _train_run(cfg, batches, G, dev, state=None, nudge=False):
    """TRAIN_REDUCED_STEPS AdamW steps of ``cfg`` on ``dev`` from the
    seed's parameters (each moved one ulp with ``nudge``), or from
    ``state``, a ``(params, opt_state)`` pair.  Returns (params,
    opt_state, [metrics of each step])."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T

    opt = optim.adamw(TRAIN_REDUCED_LR)
    B, S = batches[0]["tokens"].shape
    step_fn = steps.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", G), opt)
    if state is None:
        init = ED.init_encdec if cfg.is_encoder_decoder else T.init_lm
        params = T.params_to(init(torch.Generator().manual_seed(LM_SEED),
                                  cfg, device="cpu"), dev)
        if nudge:
            nudge_one_ulp(params, LM_SEED + 1)
        opt_state = opt.init(params)
        first = 0
    else:
        params, opt_state = state
        first = len(batches) - 1
    ms = []
    for step in range(first, len(batches)):
        batch = {k: v.to(dev) for k, v in batches[step].items()}
        params, opt_state, m = step_fn(params, opt_state, step, batch)
        ms.append(m)
    return params, opt_state, ms


def _bits_equal(a, b):
    """Whether two trees hold the same tensors bit for bit."""
    import torch
    from repro_torch.tree import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
        for x, y in zip(la, lb))


def _train_card_vs_cpu(arch):
    """(c): reduced ``arch`` in f32, card against CPU at G = 1 and 2 (the
    first loss, every grad norm and the loss trajectory; a later grad
    norm also within TRAIN_ULP_FACTOR times the parting of a CPU run one
    ulp away in every parameter); then on the
    card a checkpoint of the state after all but the last step, restored
    bit for bit, whose last step equals the continued run's bit for bit.
    Returns the kernel launches."""
    import tempfile
    import warnings

    import numpy as np
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataConfig, synthetic_token_batches
    from repro_torch.kernels import ops
    from repro_torch.tree import leaves

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(LM_SEED + 12)
    batches = [_train_batch(cfg, {k: torch.from_numpy(v.astype(np.int64))
                                  for k, v in b.items()},
                            rng, "cpu", torch.float32)
               for b in synthetic_token_batches(
                   TokenDataConfig(cfg.vocab_size, TRAIN_REDUCED_S,
                                   TRAIN_REDUCED_B, seed=LM_SEED),
                   TRAIN_REDUCED_STEPS)]
    launches = dict.fromkeys(ops.LAUNCH_COUNTS, 0)
    worst = {"loss": 0.0, "grad_norm": 0.0, "trajectory": 0.0,
             "later grad_norm": 0.0, "later grad_norm, CPU one ulp "
             "away": 0.0}

    def rel(a, b, key):
        return abs(a[key] - b[key]) / abs(b[key])

    with ops.use_pallas_scoped(True):
        for G in (1, 2):
            out = {}
            for dev, nudge in (("cpu", False), ("cuda", False),
                               ("cpu", True)):
                ops.reset_launch_counts()
                _, _, ms = _train_run(cfg, batches, G, dev, nudge=nudge)
                for k, n in ops.LAUNCH_COUNTS.items():
                    launches[k] += n
                out["ulp" if nudge else dev] = [
                    {k: float(v) for k, v in m.items()} for m in ms]
            for i, (c, w, u) in enumerate(zip(out["cuda"], out["cpu"],
                                              out["ulp"])):
                if i == 0:
                    checks = (("loss", LIMIT_TRAIN_LOSS_REL, "loss"),
                              ("grad_norm", LIMIT_TRAIN_GNORM_REL,
                               "grad_norm"))
                else:
                    ulp = rel(u, w, "grad_norm")
                    worst["later grad_norm, CPU one ulp away"] = max(
                        worst["later grad_norm, CPU one ulp away"], ulp)
                    checks = (("loss", LIMIT_TRAIN_TRAJ_REL, "trajectory"),
                              ("grad_norm", max(LIMIT_TRAIN_GNORM_REL,
                                                TRAIN_ULP_FACTOR * ulp),
                               "later grad_norm"))
                for key, limit, name in checks:
                    err = rel(c, w, key)
                    worst[name] = max(worst[name], err)
                    if not err <= limit:
                        raise AssertionError(
                            f"reduced {arch} G {G} step {i}: {key} card "
                            f"{c[key]!r} vs CPU {w[key]!r} ({err:.3e}, "
                            f"limit {limit:.3e})")
            print(f"phase 11: reduced {arch} G {G}: " + "; ".join(
                f"{label} card {[round(m[key], 6) for m in out['cuda']]}, "
                f"CPU {[round(m[key], 6) for m in out['cpu']]}, CPU one "
                f"ulp away {[round(m[key], 6) for m in out['ulp']]}"
                for key, label in (("loss", "losses"),
                                   ("grad_norm", "grad norms"))))
        # checkpoint round trip and a bit-identical continuation on the
        # card, with deterministic kernels (index_put's accumulation)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                params, opt_state, _ = _train_run(
                    cfg, batches[:-1], 2, "cuda")
                with tempfile.TemporaryDirectory() as tmp:
                    ck = Checkpointer(tmp)
                    ck.save(len(batches) - 1, {"params": params,
                                               "opt_state": opt_state})
                    template = {"params": params, "opt_state": opt_state}
                    tree, step, _ = ck.restore(template=template)
                restored = _bits_equal(tree, template) and all(
                    t.is_cuda for t in leaves(tree))
                cont = _train_run(cfg, batches, 2, "cuda",
                                  state=(params, opt_state))
                again = _train_run(cfg, batches, 2, "cuda",
                                   state=(tree["params"],
                                          tree["opt_state"]))
        finally:
            torch.use_deterministic_algorithms(False)
    same = _bits_equal(cont, again)
    print(f"phase 11: reduced {arch}: worst card vs CPU "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; checkpoint of step {step} restored bit for bit on the "
          f"card: {restored}; the next step from it equals the continued "
          f"run bit for bit: {same}")
    if not restored or not same:
        raise AssertionError(f"reduced {arch}: checkpoint round trip "
                             f"{restored}, continuation {same}")
    return launches


def phase11():
    """LM training: gemma-2b and seamless-m4t-medium at full width in
    bf16, then six families reduced, card against CPU.  Returns the
    kernel launches (none) and each full-width arch's first loss."""
    launches, first_loss = {}, {}
    for arch in TRAIN_FULL:
        counts, losses = _train_full(arch)
        launches[arch] = sum(counts.values())
        first_loss[arch] = losses[0]
    for arch in TRAIN_REDUCED:
        launches[f"reduced {arch}"] = sum(_train_card_vs_cpu(arch).values())
    if any(launches.values()):
        raise AssertionError(f"phase 11 launched kernels: {launches}")
    return launches, first_loss


def _mesh_batches(cfg, n, B, S=TRAIN_REDUCED_S):
    """``n`` reduced batches (B x S) from the token pipeline's generator,
    with the frames or prefix embeddings, on the host."""
    import numpy as np
    import torch
    from repro_torch.data import TokenDataConfig, synthetic_token_batches

    rng = np.random.default_rng(LM_SEED + 13)
    return [_train_batch(cfg, {k: torch.from_numpy(v.astype(np.int64))
                               for k, v in b.items()},
                         rng, "cpu", torch.float32)
            for b in synthetic_token_batches(
                TokenDataConfig(cfg.vocab_size, S, B, seed=LM_SEED), n)]


def _mesh_run(cfg, batches, G, mesh):
    """TRAIN_REDUCED_LR AdamW steps of reduced ``cfg`` from the seed's
    parameters: on ``mesh`` (placed by ``shard_params``), or on the card
    without one (``mesh`` None).  Returns (params, opt_state, [metrics as
    floats])."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import shard_params

    opt = optim.adamw(TRAIN_REDUCED_LR)
    B, S = batches[0]["tokens"].shape
    step_fn = steps.make_train_step(
        cfg, ShapeConfig("custom_train", S, B, "train", G), opt, mesh=mesh)
    init = ED.init_encdec if cfg.is_encoder_decoder else T.init_lm
    params = T.params_to(init(torch.Generator().manual_seed(LM_SEED), cfg,
                              device="cpu"), "cuda")
    if mesh is not None:
        params = shard_params(params, mesh)
    opt_state = opt.init(params)
    ms = []
    for step, batch in enumerate(batches):
        params, opt_state, m = step_fn(
            params, opt_state, step,
            {k: v.to("cuda") for k, v in batch.items()})
        ms.append({k: float(v) for k, v in m.items()})
    return params, opt_state, ms


def _deterministic():
    """Deterministic kernels (index_put's accumulation), warnings off."""
    import warnings

    import torch

    @contextlib.contextmanager
    def ctx():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                yield
        finally:
            torch.use_deterministic_algorithms(False)
    return ctx()


def phase12a():
    """D = 1 on (cuda:0,): the mesh step is ``make_train_step``'s step bit
    for bit (every metric, parameter and moment), G 1 and 2."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import leaves

    mesh = make_test_mesh(1, 1, devices=("cuda:0",))
    for arch in MESH_EXACT:
        cfg = get_config(arch).reduced()
        batches = _mesh_batches(cfg, MESH_REDUCED_STEPS, MESH_REDUCED_B)
        for G in (1, 2):
            with _deterministic():
                p0, s0, m0 = _mesh_run(cfg, batches, G, None)
                p1, s1, m1 = _mesh_run(cfg, batches, G, mesh)
            same = m0 == m1 and all(
                len(y.shards) == 1 and torch.equal(x, y.shards[0])
                for a, b in ((p0, p1), (s0, s1))
                for x, y in zip(leaves(a), leaves(b)))
            print(f"phase 12a: reduced {arch} G {G}, D = 1 mesh vs no mesh: "
                  f"losses {[m['loss'] for m in m1]}, grad norms "
                  f"{[m['grad_norm'] for m in m1]}; every metric, parameter "
                  f"and moment bit for bit: {same}")
            if not same:
                raise AssertionError(f"phase 12a: reduced {arch} G {G}: the "
                                     f"one-device mesh step differs")


def _mesh_vs_one(arch, mesh, label, phase="12b", want=None, cfg=None,
                 S=TRAIN_REDUCED_S):
    """(b): reduced ``arch`` (or ``cfg``) on ``mesh`` against the card's
    D = 1 step (``want``: its metrics, run here if None) on batches of
    MESH_REDUCED_B x ``S`` tokens: the first loss and grad norm, the
    loss trajectory, an MoE config's ``aux`` at every step, every chunk
    held by several devices identical to its owner's, and a checkpoint
    of the sharded state byte-identical to the same state's on one
    device, restored at D = 1.  Returns the D = 1 metrics."""
    import filecmp
    import os
    import tempfile

    import torch
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import gather_params, shard_params
    from repro_torch.tree import leaves

    cfg = cfg or get_config(arch).reduced()
    batches = _mesh_batches(cfg, MESH_REDUCED_STEPS, MESH_REDUCED_B, S)
    one = make_test_mesh(1, 1, devices=("cuda:0",))
    if want is None:
        _, _, want = _mesh_run(cfg, batches, MESH_REDUCED_MICRO, one)
    params, opt_state, got = _mesh_run(cfg, batches, MESH_REDUCED_MICRO,
                                       mesh)
    D = mesh.size

    def rel(i, key):
        return abs(got[i][key] - want[i][key]) / abs(want[i][key])

    worst = {"first loss": rel(0, "loss"), "first grad_norm":
             rel(0, "grad_norm"), "trajectory": max(
                 rel(i, "loss") for i in range(1, len(got)))}
    limits = {"first loss": LIMIT_TRAIN_LOSS_REL,
              "first grad_norm": LIMIT_TRAIN_GNORM_REL,
              "trajectory": LIMIT_TRAIN_TRAJ_REL}
    if want[0].get("aux"):
        # the first step's: past it AdamW's sign-like update turns
        # eps-sized gradient differences into parameter differences of up
        # to ~1e-4, which may flip a token's top-k experts, and aux counts
        # the rows each expert takes (the loss trajectory holds them)
        worst["first aux"] = rel(0, "aux")
        limits["first aux"] = LIMIT_AUX_REL
    state = {"params": params, "opt_state": opt_state}
    copied = [x for x in leaves(state)
              if any(x.owner(d) != d for d in range(D))]
    copies = all(torch.equal(s.to(x.shards[x.owner(d)].device),
                             x.shards[x.owner(d)])
                 for x in copied for d, s in enumerate(x.shards))
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "d.npz"), os.path.join(tmp, "one.npz")
        save_pytree(a, state)
        whole = gather_params(state, "cuda:0")
        save_pytree(b, {k: shard_params(v, one) for k, v in whole.items()})
        same_file = filecmp.cmp(a, b, shallow=False)
        template = {k: shard_params(v, one) for k, v in whole.items()}
        back = load_pytree(a, template)
        restored = all(torch.equal(x.shards[0], w) for x, w in
                       zip(leaves(back), leaves(whole)))
    print(f"phase {phase}: reduced {arch} {label} vs D = 1 (G "
          f"{MESH_REDUCED_MICRO}): losses {[m['loss'] for m in got]} vs "
          f"{[m['loss'] for m in want]}, grad norms "
          f"{[m['grad_norm'] for m in got]} vs "
          f"{[m['grad_norm'] for m in want]}"
          + (f", aux {[m['aux'] for m in got]} vs {[m['aux'] for m in want]}"
             if "first aux" in worst else "") + "; "
          + ", ".join(f"{k} {v:.3e} (limit {limits[k]:.0e})"
                      for k, v in worst.items())
          + f"; {len(copied)} leaves held by several of the {D} devices "
          f"identical to their owners': {copies}; sharded checkpoint "
          f"byte-identical to D = 1's: {same_file}, restored at D = 1 bit "
          f"for bit: {restored}")
    bad = {k: v for k, v in worst.items() if not v <= limits[k]}
    if bad or not copies or not same_file or not restored:
        raise AssertionError(f"phase {phase}: reduced {arch} {label}: "
                             f"{bad}, copies {copies}, checkpoint "
                             f"{same_file}, restored {restored}")
    return want


def phase12b():
    from repro_torch.launch.mesh import make_test_mesh

    for arch in MESH_REDUCED:
        for D in MESH_COUNTS:
            _mesh_vs_one(arch,
                         make_test_mesh(D, 1, devices=("cuda:0",) * D),
                         f"D = {D} on (cuda:0,) * {D}")


def _sync_all(mesh):
    import torch
    for dev in dict.fromkeys(mesh.devices):
        torch.cuda.synchronize(dev)


def _mesh_full(arch, mesh, steps_n, label, profile=False, lr=None,
               phase="12", cfg=None, reference=False):
    """``arch`` (or ``cfg``, a depth cut of it) at full width in bf16 on
    ``mesh``: the launcher's optimizer (AdamW at a constant ``lr`` if
    given), phase 11a's batch of TRAIN_BATCH x TRAIN_SEQ tokens (the
    pipeline's row shards) in TRAIN_MICRO microbatches, ``steps_n``
    steps timed (the last profiled with ``profile``).  Returns the
    losses and each card's peak GiB; with ``reference`` also the first
    batch's loss from a no-grad ``lm_train_loss`` of the freshly drawn
    model, whole on the mesh's first device (the mean of its
    microbatches' losses, as the step's metric), before it is placed."""
    import gc

    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenDataConfig, make_batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import shard_params

    cfg = cfg or get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    shape = ShapeConfig("custom_train", TRAIN_SEQ, TRAIN_BATCH, "train",
                        TRAIN_MICRO)
    R = len(mesh.replicas)
    G = steps.num_microbatches(cfg, shape, R)
    whole = T.init_lm(
        torch.Generator(device=mesh.devices[0]).manual_seed(LM_SEED), cfg,
        device=mesh.devices[0])
    ref = None
    if reference:
        ref = _whole_loss(cfg, whole, mesh.devices[0], G)
        print(f"phase {phase}: {arch} {label}: the whole model's no-grad "
              f"first loss on {mesh.devices[0]}: {ref!r}")
    params = shard_params(whole, mesh)
    del whole
    opt = (steps.make_optimizer(cfg, steps_n) if lr is None
           else optim.adamw(lr))
    opt_state = opt.init(params)
    cards = list(dict.fromkeys(mesh.devices))
    gc.collect()
    _sync_all(mesh)
    for dev in cards:
        torch.cuda.reset_peak_memory_stats(dev)
    print(f"phase {phase}: {arch} {label}: {_numel(params) / 1e9:.3f}e9 "
          f"parameters in {cfg.param_dtype}, sharded by the rule engine; "
          f"global batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {G} "
          f"microbatches of {TRAIN_BATCH // G // R} rows a replica of "
          f"{mesh.ranks} ranks; "
          + ", ".join(f"{dev} {torch.cuda.memory_allocated(dev) / 2**30:.2f}"
                      f" GiB" for dev in cards) + " allocated")
    data = make_batch_iterator(
        TokenDataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=LM_SEED), num_batches=steps_n, mesh=mesh,
        microbatches=G)
    times, losses, norms = [], [], []
    wall = busy = None
    with ops.use_pallas_scoped(True):
        step_fn = steps.make_train_step(cfg, shape, opt, mesh=mesh)
        ops.reset_launch_counts()
        for step, shards in enumerate(data):
            if profile and step == steps_n - 1:
                (params, opt_state, m), wall, busy = profile_device(
                    phase, f"{arch} {label} train step", lambda: step_fn(
                        params, opt_state, step, shards), host_top=4)
            else:
                _sync_all(mesh)
                t0 = time.perf_counter()
                params, opt_state, m = step_fn(params, opt_state, step,
                                               shards)
                _sync_all(mesh)
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        _sync_all(mesh)
        launches = sum(ops.LAUNCH_COUNTS.values())
    peaks = {str(dev): torch.cuda.max_memory_allocated(dev) / 2**30
             for dev in cards}
    step_ms = statistics.median(times[1:])
    print(f"phase {phase}: {arch} {label}: losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}; step {step_ms:.3f} ms (host "
          f"clock ending in a synchronize of every card, median of steps "
          f"2-{len(times)}; all {[round(t, 3) for t in times]}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tok/s; peak "
          f"device memory " + ", ".join(f"{k} {v:.2f} GiB"
                                        for k, v in peaks.items())
          + ("" if wall is None else f"; profiled step wall {wall:.3f} ms,"
             f" busy {busy:.3f} ms") + f"; kernel launches {launches}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"phase {phase}: {arch} {label}: a loss or grad "
                             f"norm is not finite")
    if launches:
        raise AssertionError(f"phase {phase}: {arch} {label}: training launched "
                             f"{launches} kernels")
    del params, opt_state, step_fn, m
    gc.collect()
    torch.cuda.empty_cache()
    return (losses, peaks, ref) if reference else (losses, peaks)


def _whole_loss(cfg, params, dev, G):
    """The first batch of TRAIN_BATCH x TRAIN_SEQ tokens' loss from a
    no-grad ``lm_train_loss`` of ``params`` (whole, on ``dev``): the mean
    of its G microbatches' losses (an MoE layer routes each microbatch's
    tokens)."""
    import numpy as np
    import torch
    from repro_torch.data import TokenDataConfig, synthetic_token_batches
    from repro_torch.models import transformer as T

    batch = next(iter(synthetic_token_batches(TokenDataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=LM_SEED), 1)))
    batch = {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(dev)
             for k, v in batch.items()}
    rows = TRAIN_BATCH // G
    with torch.no_grad():
        losses = [float(T.lm_train_loss(params, cfg, {
            k: v[g * rows:(g + 1) * rows] for k, v in batch.items()})[0])
            for g in range(G)]
    return sum(losses) / G


def phase12c(first_loss):
    """gemma-2b at full width over (cuda:0,) * 2; its first loss against
    phase 11a's D = 1 loss (``first_loss``)."""
    from repro_torch.launch.mesh import make_test_mesh

    D = MESH_FULL_D
    losses, _ = _mesh_full(MESH_FULL_ARCH,
                           make_test_mesh(D, 1, devices=("cuda:0",) * D),
                           MESH_FULL_STEPS, f"D = {D} on (cuda:0,) * {D}",
                           profile=True)
    err = abs(losses[0] - first_loss) / abs(first_loss)
    print(f"phase 12c: {MESH_FULL_ARCH} D = {D} first loss {losses[0]!r} vs "
          f"phase 11a's D = 1 {first_loss!r}: {err:.3e} relative (limit "
          f"{LIMIT_MESH_BF16_LOSS_REL:.0e})")
    if not err <= LIMIT_MESH_BF16_LOSS_REL:
        raise AssertionError(f"phase 12c: first loss {err:.3e} apart")


def phase12d():
    """With MESH_4_CARDS cards: reduced qwen2-7b over cuda:0-3 against
    D = 1 as in (b), then qwen2-7b at full width in bf16 over the cards,
    whose loss must fall.  With fewer, one line says so."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh

    visible = torch.cuda.device_count()
    if visible < MESH_4_CARDS:
        print(f"phase 12d: not run: it needs {MESH_4_CARDS} cards, "
              f"{visible} visible")
        return
    mesh = make_test_mesh(MESH_4_CARDS, 1, device="cuda:0")
    label = f"D = {MESH_4_CARDS} on {[str(d) for d in mesh.devices]}"
    _mesh_vs_one(MESH_4_ARCH, mesh, label)
    losses, _ = _mesh_full(MESH_4_ARCH, mesh, MESH_4_STEPS, label,
                           lr=MESH_4_LR)
    print(f"phase 12d: {MESH_4_ARCH} loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} in {MESH_4_STEPS} steps of AdamW at "
          f"{MESH_4_LR}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase 12d: the loss did not fall: {losses}")


def phase12(first_loss):
    """Data-parallel LM training over a mesh; ``first_loss``: phase 11a's
    first gemma-2b loss."""
    phase12a()
    phase12b()
    phase12c(first_loss)
    phase12d()


def _no_launches(phase, fn):
    """``fn()`` with the kernels on, raising if it launched any."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    with ops.use_pallas_scoped(True):
        out = fn()
    launches = sum(ops.LAUNCH_COUNTS.values())
    if launches:
        raise AssertionError(f"phase {phase}: training launched "
                             f"{launches} kernels")
    return out


def phase13a():
    """Six reduced families tensor-parallel at TP_MESHES on (cuda:0,) *
    n against the card's D = 1 step."""
    from repro_torch.launch.mesh import make_test_mesh

    for arch in TP_REDUCED:
        want = None
        for data, model in TP_MESHES:
            n = data * model
            mesh = make_test_mesh(data, model, devices=("cuda:0",) * n)
            want = _no_launches("13a", lambda: _mesh_vs_one(
                arch, mesh, f"(data, model) = ({data}, {model}) on "
                f"(cuda:0,) * {n}", "13a", want))
    print("phase 13a: 0 kernel launches")


def phase13b(first_loss):
    """gemma-2b at full width at TP_FULL_MESH on one card; its first loss
    against phase 11a's D = 1 loss (``first_loss``)."""
    from repro_torch.launch.mesh import make_test_mesh

    data, model = TP_FULL_MESH
    n = data * model
    losses, _ = _mesh_full(
        TP_FULL_ARCH, make_test_mesh(data, model, devices=("cuda:0",) * n),
        TP_FULL_STEPS, f"(data, model) = ({data}, {model}) on (cuda:0,) * "
        f"{n}", phase="13b")
    err = abs(losses[0] - first_loss) / abs(first_loss)
    print(f"phase 13b: {TP_FULL_ARCH} at ({data}, {model}) first loss "
          f"{losses[0]!r} vs phase 11a's D = 1 {first_loss!r}: {err:.3e} "
          f"relative (limit {LIMIT_MESH_BF16_LOSS_REL:.0e})")
    if not err <= LIMIT_MESH_BF16_LOSS_REL:
        raise AssertionError(f"phase 13b: first loss {err:.3e} apart")


def phase13c():
    """With four cards: reduced qwen3-14b at (1, 4) against D = 1, then
    TP_4_FULL at full width, whose losses must fall and whose peaks must
    fit each card.  With fewer, one line says so."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh

    visible = torch.cuda.device_count()
    if visible < MESH_4_CARDS:
        print(f"phase 13c: not run: it needs {MESH_4_CARDS} cards, "
              f"{visible} visible")
        return
    arch, (data, model) = TP_4_REDUCED
    mesh = make_test_mesh(data, model, device="cuda:0")
    label = f"(data, model) = ({data}, {model}) on " \
        f"{[str(d) for d in mesh.devices]}"
    _no_launches("13c", lambda: _mesh_vs_one(arch, mesh, label, "13c"))
    for arch, (data, model) in TP_4_FULL:
        mesh = make_test_mesh(data, model, device="cuda:0")
        label = f"(data, model) = ({data}, {model}) on " \
            f"{[str(d) for d in mesh.devices]}"
        losses, peaks = _mesh_full(arch, mesh, TP_4_STEPS, label,
                                   lr=MESH_4_LR, phase="13c")
        caps = {str(d): torch.cuda.get_device_properties(d).total_memory
                / 2**30 for d in mesh.devices}
        print(f"phase 13c: {arch} at ({data}, {model}) loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} in {TP_4_STEPS} steps "
              f"of AdamW at {MESH_4_LR}; peak / memory by card "
              + ", ".join(f"{k} {v:.2f} / {caps[k]:.2f} GiB"
                          for k, v in peaks.items()))
        if not losses[-1] < losses[0]:
            raise AssertionError(f"phase 13c: {arch}: the loss did not "
                                 f"fall: {losses}")
        if not all(v < caps[k] for k, v in peaks.items()):
            raise AssertionError(f"phase 13c: {arch}: a peak exceeds its "
                                 f"card: {peaks}")


def phase13(first_loss):
    """Tensor-parallel LM training; ``first_loss``: phase 11a's first
    gemma-2b loss."""
    phase13a()
    phase13b(first_loss)
    phase13c()


def _moe_cfg(arch):
    """Reduced ``arch`` at capacity factor MOE_MESH_CAPACITY, and the
    sequence length that gives its microbatches MOE_MESH_ROWS expanded
    rows (MESH_REDUCED_B rows in MESH_REDUCED_MICRO microbatches)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              capacity_factor=MOE_MESH_CAPACITY)
    S = MOE_MESH_ROWS * MESH_REDUCED_MICRO // (MESH_REDUCED_B
                                               * cfg.experts_per_token)
    return cfg, S


def _moe_dropped(cfg, S):
    """The dropped share of each MoE layer of reduced ``cfg`` on the
    first microbatch of phase 14a's first batch, from the card's D = 1
    forward (the parameters ``_mesh_run`` draws), and that microbatch's
    tokens."""
    import torch
    from repro_torch.models import transformer as T

    batch = _mesh_batches(cfg, 1, MESH_REDUCED_B, S)[0]
    tokens = batch["tokens"][:MESH_REDUCED_B // MESH_REDUCED_MICRO]
    params = T.params_to(T.init_lm(torch.Generator().manual_seed(LM_SEED),
                                   cfg, device="cpu"), "cuda")
    with torch.no_grad():
        h = T.embed_inputs(params, cfg, tokens.to("cuda"))
        _, _, aux = T.lm_hidden(params, cfg, h, positions=torch.arange(
            h.shape[1], device=h.device), window=cfg.attn_window)
    return [float(m["moe_dropped_frac"]) for m in aux], tokens.numel()


def phase14a():
    """The four reduced MoE families at MOE_MESH_MESHES on (cuda:0,) * n
    against the card's D = 1 step, on batches whose microbatches bind
    the capacity over the whole microbatch but not over one replica."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as MOE

    for arch in MOE_MESH_REDUCED:
        cfg, S = _moe_cfg(arch)
        dropped, T = _moe_dropped(cfg, S)
        k = cfg.experts_per_token
        lossless = MOE._capacity(T // 2, cfg) == T // 2 * k
        print(f"phase 14a: reduced {arch} at capacity factor "
              f"{cfg.capacity_factor}, batch {MESH_REDUCED_B} x {S}, G "
              f"{MESH_REDUCED_MICRO}: a microbatch's {T * k} expanded rows, "
              f"capacity {MOE._capacity(T, cfg)}; D = 1 dropped share by MoE "
              f"layer {dropped}; one of two replicas' {T // 2 * k} rows "
              f"lossless: {lossless}")
        if not (min(dropped) > 0 and lossless):
            raise AssertionError(f"phase 14a: {arch}: the batch does not "
                                 f"bind the capacity over the microbatch "
                                 f"alone")
        want = None
        for data, model in MOE_MESH_MESHES:
            n = data * model
            mesh = make_test_mesh(data, model, devices=("cuda:0",) * n)
            want = _no_launches("14a", lambda: _mesh_vs_one(
                arch, mesh, f"(data, model) = ({data}, {model}) on "
                f"(cuda:0,) * {n}", "14a", want, cfg=cfg, S=S))
    print("phase 14a: 0 kernel launches")


def _launcher_over_cards(phase, args, cards):
    """``python -m repro_torch.launch.train`` with ``args`` in a
    subprocess over every visible card: exit 0, ``cards`` devices, a
    final loss."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], cwd=str(REPO), env=env, capture_output=True,
                         text=True, timeout=MOE_4_LAUNCHER_TIMEOUT_S)
    lines = out.stdout.strip().splitlines()
    print(f"phase {phase}: launcher {' '.join(args)}: exit {out.returncode} "
          f"in {time.perf_counter() - t0:.1f} s; "
          + " | ".join(lines[:1] + lines[-2:]))
    if out.returncode or f"devices={cards}" not in out.stdout \
            or "final loss" not in out.stdout:
        raise AssertionError(f"phase {phase}: the launcher failed: "
                             f"{out.stderr[-2000:]}")


def phase14b():
    """With four cards: reduced moonshot at (2, 2) over cuda:0-3 against
    D = 1, the launcher over the cards, then MOE_4_FULL at full width
    (depth cut), whose first loss must match the whole model's forward,
    whose losses must fall and whose peaks must fit each card.  With
    fewer cards, one line says so."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh

    visible = torch.cuda.device_count()
    if visible < MESH_4_CARDS:
        print(f"phase 14b: not run: it needs {MESH_4_CARDS} cards, "
              f"{visible} visible")
        return
    arch, (data, model) = MOE_4_REDUCED
    cfg, S = _moe_cfg(arch)
    mesh = make_test_mesh(data, model, device="cuda:0")
    _no_launches("14b", lambda: _mesh_vs_one(
        arch, mesh, f"(data, model) = ({data}, {model}) on "
        f"{[str(d) for d in mesh.devices]}", "14b", cfg=cfg, S=S))
    torch.cuda.empty_cache()
    _launcher_over_cards("14b", MOE_4_LAUNCHER, visible)
    for arch, (data, model), layers in MOE_4_FULL:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        print(f"phase 14b: {arch} reduced: " + json.dumps({
            "num_layers": [full.num_layers, cfg.num_layers],
            "param_count": [full.param_count(), cfg.param_count()],
            "why": "the full depth's training state does not fit four "
                   f"cards; the cut keeps the first {layers} layers ("
                   f"{cfg.first_dense_layers} dense, "
                   f"{layers - cfg.first_dense_layers} MoE)"
                   + (" and the MTP head" if cfg.mtp_depth else "")}))
        mesh = make_test_mesh(data, model, device="cuda:0")
        label = f"(data, model) = ({data}, {model}) on " \
            f"{[str(d) for d in mesh.devices]}"
        losses, peaks, ref = _mesh_full(arch, mesh, MOE_4_STEPS, label,
                                        profile=True, lr=MESH_4_LR,
                                        phase="14b", cfg=cfg, reference=True)
        caps = {str(d): torch.cuda.get_device_properties(d).total_memory
                / 2**30 for d in mesh.devices}
        err = abs(losses[0] - ref) / abs(ref)
        print(f"phase 14b: {arch} at ({data}, {model}): first loss "
              f"{losses[0]!r} vs the whole model's {ref!r}: {err:.3e} "
              f"relative (limit {LIMIT_MESH_BF16_LOSS_REL:.0e}); loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} in {MOE_4_STEPS} steps "
              f"of AdamW at {MESH_4_LR}; peak / memory by card "
              + ", ".join(f"{k} {v:.2f} / {caps[k]:.2f} GiB"
                          for k, v in peaks.items()))
        if not err <= LIMIT_MESH_BF16_LOSS_REL:
            raise AssertionError(f"phase 14b: {arch}: first loss {err:.3e} "
                                 f"apart")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"phase 14b: {arch}: the loss did not "
                                 f"fall: {losses}")
        if not all(v < caps[k] for k, v in peaks.items()):
            raise AssertionError(f"phase 14b: {arch}: a peak exceeds its "
                                 f"card: {peaks}")


def phase14():
    """The MoE families trained over a data x model mesh."""
    phase14a()
    phase14b()


# -- phase 15: serving over a data x model mesh --------------------------------

def _serve_prompt(cfg, B, S, seed=LM_SEED):
    """``B`` rows of ``S`` token ids (and a VLM's prefix embeddings, an
    encoder-decoder's ``encoder_seq_len`` source frames) drawn from
    ``seed``, on cuda:0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                    device="cuda:0")}
    dt = getattr(torch, cfg.compute_dtype)
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = torch.tensor(
            rng.standard_normal((B, cfg.num_prefix_embeds, cfg.d_model)),
            dtype=dt, device="cuda:0")
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = torch.tensor(
            rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)),
            dtype=dt, device="cuda:0")
    return batch


def _b9_per_rank(cfg):
    """B9 launches of a prefill on one rank (or one device): an
    attention layer's (MLA's too), or the encoder-decoder's three
    roles (encoder, decoder self, cross)."""
    if cfg.is_encoder_decoder:
        return cfg.num_encoder_layers + 2 * cfg.num_layers
    return sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))


def _b10_per_rank(cfg):
    if cfg.is_encoder_decoder:
        return 0
    return cfg.num_layers - _b9_per_rank(cfg)


def _init_whole(cfg, seed, device="cuda"):
    """Random ``cfg`` parameters drawn from ``seed`` on ``device``."""
    import torch
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=device).manual_seed(seed)
    init = ED.init_encdec if cfg.is_encoder_decoder else T.init_lm
    return init(gen, cfg, device=device)


def _serve_pos(cfg, B, at, device="cuda:0"):
    """A decode's first position: one int for the encoder-decoder (its
    rows step in lockstep), else a (B,) tensor."""
    import torch

    if cfg.is_encoder_decoder:
        return at
    return torch.full((B,), at, device=device)


def _serve(prefill, decode, params, batch, pos, steps_n, sync=None,
           feed=None):
    """A prefill and ``steps_n`` greedy decode steps at positions ``pos +
    i`` (``feed``: the tokens to feed instead, one (B, 1) a step):
    (every step's logits, every fed token, B9 and B10 launches of the
    prefill, launches of the decode steps, decode seconds)."""
    import torch
    from repro_torch.kernels import ops

    sync = sync or torch.cuda.synchronize
    ops.reset_launch_counts()
    logits, caches = prefill(params, batch)
    sync()
    pre = dict(ops.LAUNCH_COUNTS)
    out, toks = [logits], []
    t0 = time.perf_counter()
    for i in range(steps_n):
        tok = logits.argmax(-1, keepdim=True) if feed is None else feed[i]
        toks.append(tok)
        logits, caches = decode(params, caches, tok, pos + i)
        out.append(logits)
    sync()
    seconds = time.perf_counter() - t0
    dec = sum(ops.LAUNCH_COUNTS.values()) - sum(pre.values())
    del caches
    return out, toks, pre, dec, seconds


def _serve_reduced_case(phase, cfg, label, params, batch, pos, steps_n,
                        pre_shape, dec_shape, mesh, launches):
    """The bundles over ``mesh`` against the card's one-device steps on
    a reduced ``cfg``: logits within LIMIT_LOGIT_REL, the same tokens,
    B9 and B10 layers x devices times a prefill and never in a decode
    step."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models.sharding import shard_params

    want, want_toks, pre, _, _ = _serve(
        steps.make_prefill_step(cfg, pre_shape),
        steps.make_decode_step(cfg, dec_shape), params, batch, pos, steps_n)
    for name in launches:
        launches[name] += pre[name]
    got, toks, pre, dec, _ = _serve(
        steps.build_step(cfg, pre_shape, mesh).fn,
        steps.build_step(cfg, dec_shape, mesh).fn,
        shard_params(params, mesh), batch, pos, steps_n)
    for name in launches:
        launches[name] += pre[name]
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(toks, want_toks))
    n = mesh.size
    b9, b10 = _b9_per_rank(cfg), _b10_per_rank(cfg)
    print(f"phase {phase}: reduced {label} at (data, model) = "
          f"{mesh.sizes} on (cuda:0,) * {n}: prefill and {steps_n} decode "
          f"steps, worst logit error {max(errs):.3e} of the largest (limit "
          f"{LIMIT_LOGIT_REL:.0e}); same tokens: {same}; B9 "
          f"{pre['flash_attention']} and B10 {pre['ssd_chunk']} launches a "
          f"prefill ({b9} and {b10} a rank x {n} ranks); {dec} in the "
          f"decode steps")
    if not (max(errs) <= LIMIT_LOGIT_REL and same):
        raise AssertionError(f"phase {phase}: {label} at {mesh.sizes} parts "
                             f"from one device")
    if (pre["flash_attention"], pre["ssd_chunk"], dec) != (b9 * n, b10 * n,
                                                           0):
        raise AssertionError(f"phase {phase}: {label}: launches {pre}, "
                             f"{dec} in decode")


def phase15a():
    """SERVE_REDUCED served over SERVE_MESHES on (cuda:0,) * n, and
    SERVE_LONG_REDUCED at batch 1 over (2, 2), against the card's
    one-device steps.  Returns the B9 and B10 launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh

    B, S = SERVE_REDUCED_B, SERVE_REDUCED_CACHE
    pre_shape = ShapeConfig("prefill", S, B, "prefill")
    dec_shape = ShapeConfig("decode", S, B, "decode")
    launches = {"flash_attention": 0, "ssd_chunk": 0}
    with ops.use_pallas_scoped(True):
        for arch in SERVE_REDUCED:
            cfg = get_config(arch).reduced()
            params = _init_whole(cfg, LM_SEED)
            batch = _serve_prompt(cfg, B, SERVE_REDUCED_PROMPT)
            # the encoder-decoder's rows step in lockstep
            pos = SERVE_REDUCED_PROMPT if cfg.is_encoder_decoder else \
                _tensor_cuda(SERVE_REDUCED_POS) + cfg.num_prefix_embeds
            for data, model in SERVE_MESHES:
                mesh = make_test_mesh(data, model,
                                      devices=("cuda:0",) * (data * model))
                _serve_reduced_case("15a", cfg, arch, params, batch, pos,
                                    SERVE_REDUCED_STEPS, pre_shape,
                                    dec_shape, mesh, launches)
        # batch 1 at a long_500k-named shape: every replica runs the
        # row, the caches' sequence cut over (data, model)
        rows = SERVE_LONG_REDUCED_CACHE
        pre_shape = ShapeConfig("prefill", rows, 1, "prefill")
        dec_shape = ShapeConfig("long_500k", rows, 1, "decode")
        mesh = make_test_mesh(2, 2, devices=("cuda:0",) * 4)
        for arch in SERVE_LONG_REDUCED:
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      long_context_window=SERVE_LONG_WINDOW)
            _serve_reduced_case(
                "15a", cfg, f"{arch} at batch 1, {rows} rows, window "
                f"{SERVE_LONG_WINDOW}", _init_whole(cfg, LM_SEED),
                _serve_prompt(cfg, 1, SERVE_LONG_REDUCED_PROMPT),
                SERVE_LONG_REDUCED_POS, SERVE_LONG_REDUCED_STEPS, pre_shape,
                dec_shape, mesh, launches)
    return launches


def _tensor_cuda(values):
    import torch
    return torch.tensor(values, device="cuda:0")


def _init_on_mesh(cfg, mesh, seed):
    """Random ``cfg`` parameters (``transformer.init_lm``'s, from
    ``seed``) placed on ``mesh`` part by part: each drawn whole on the
    mesh's first device (which holds a shard of every leaf), cut by
    ``sharding.placer`` and freed, so no device ever holds more than its
    shards and one part.  The encoder-decoder (0.877e9 parameters) is
    drawn whole and cut."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import placer, shard_params

    dev = mesh.devices[0]
    if cfg.is_encoder_decoder:
        whole = _init_whole(cfg, seed, dev)
        placed = shard_params(whole, mesh)
        del whole
        return placed
    gen = torch.Generator(device=dev).manual_seed(seed)
    return T.init_lm(gen, cfg, device=dev, place=placer(mesh))


def _serve_sizes(cfg):
    """(rows, prompt, cache rows, decode steps) of a full-width serve:
    the encoder-decoder's phase 10 batch, else SERVE_4's."""
    if cfg.is_encoder_decoder:
        return ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_SEQ, ENCDEC_NEW_TOKENS
    return SERVE_4_ROWS, SERVE_4_PROMPT, SERVE_4_CACHE, SERVE_4_STEPS


def _serve_mesh_full(arch, mesh, phase="15b", layers=None):
    """``arch`` at full width in bf16 (depth cut to ``layers`` where
    given) served over ``mesh``: prefill ms, decode tok/s, launches and
    each card's peak."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    if layers is not None:
        print(f"phase {phase}: {arch} reduced: " + json.dumps({
            "num_layers": [full.num_layers, cfg.num_layers],
            "param_count": [full.param_count(), cfg.param_count()],
            "why": f"the first {layers} layers ({cfg.first_dense_layers} "
                   f"dense, {layers - cfg.first_dense_layers} MoE) and the "
                   f"MTP head: the {full.num_layers} layers do not fit four "
                   f"cards, and each MoE layer is drawn whole on cuda:0"}))
    B, P, S, steps_n = _serve_sizes(cfg)
    label = (f"(data, model) = {mesh.sizes} on "
             f"{[str(d) for d in mesh.devices]}")
    cards = list(dict.fromkeys(mesh.devices))
    gc.collect()
    torch.cuda.empty_cache()
    for dev in cards:
        # a card's allocator takes a reset only once it has allocated
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    params = _init_on_mesh(cfg, mesh, LM_SEED)
    _sync_all(mesh)
    draw_peak = torch.cuda.max_memory_allocated(cards[0]) / 2**30
    print(f"phase {phase}: {arch} {label}: {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters in {cfg.param_dtype} placed layer by layer "
          f"({cards[0]} peaked at {draw_peak:.2f} GiB while drawing); "
          + ", ".join(f"{dev} {torch.cuda.memory_allocated(dev) / 2**30:.2f}"
                      f" GiB" for dev in cards) + " allocated")
    for dev in cards:
        torch.cuda.reset_peak_memory_stats(dev)
    prefill = steps.build_step(cfg, ShapeConfig("serve", S, B, "prefill"),
                               mesh).fn
    decode = steps.build_step(cfg, ShapeConfig("serve", S, B, "decode"),
                              mesh).fn
    batch = _serve_prompt(cfg, B, P)
    pos = _serve_pos(cfg, B, P)
    b9, b10 = _b9_per_rank(cfg), _b10_per_rank(cfg)
    launches = {"flash_attention": 0, "ssd_chunk": 0}
    with ops.use_pallas_scoped(True):
        times = []
        for _ in range(SERVE_4_PREFILLS):
            ops.reset_launch_counts()
            _sync_all(mesh)
            t0 = time.perf_counter()
            logits, caches = prefill(params, batch)
            _sync_all(mesh)
            times.append((time.perf_counter() - t0) * 1e3)
            pre = dict(ops.LAUNCH_COUNTS)
            for name in launches:
                launches[name] += pre[name]
            del logits, caches
        out, _, pre, dec, seconds = _serve(
            prefill, decode, params, batch, pos, steps_n,
            sync=lambda: _sync_all(mesh))
        for name in launches:
            launches[name] += pre[name]
        logits, caches = prefill(params, batch)
        tok = logits.argmax(-1, keepdim=True)
        profile_device(
            phase, f"{arch} decode step", lambda: decode(
                params, caches, tok, pos), host_top=3)
        del logits, caches
    peaks = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
             for d in cards}
    caps = {str(d): torch.cuda.get_device_properties(d).total_memory / 2**30
            for d in cards}
    finite = all(bool(torch.isfinite(x).all()) for x in out)
    print(f"phase {phase}: {arch} {label}: {B} rows of {P} tokens, a "
          f"{S}-row cache: prefill {statistics.median(times):.3f} ms (median "
          f"of {SERVE_4_PREFILLS}, host clock ending in a synchronize of "
          f"every card; all {[round(t, 3) for t in times]}); {steps_n} "
          f"greedy decode steps {B * steps_n / seconds:.1f} tok/s "
          f"({seconds * 1e3 / steps_n:.3f} ms a step); B9 "
          f"{pre['flash_attention']} and B10 {pre['ssd_chunk']} launches a "
          f"prefill ({b9} and {b10} a rank x {mesh.size} ranks), "
          f"{dec / steps_n:.0f} kernel launches of ours a decode step "
          f"(host launches in the profile above); finite logits: {finite}; "
          f"serving peak / memory by card " + ", ".join(
              f"{k} {v:.2f} / {caps[k]:.2f} GiB" for k, v in peaks.items()))
    if (pre["flash_attention"], pre["ssd_chunk"]) != (
            b9 * mesh.size, b10 * mesh.size) or dec or not finite:
        raise AssertionError(f"phase {phase}: {arch}: launches {pre}, {dec} "
                             f"in decode; finite {finite}")
    if not all(v < caps[k] for k, v in peaks.items()) or \
            draw_peak >= caps[str(cards[0])]:
        raise AssertionError(f"phase {phase}: {arch}: a peak exceeds its "
                             f"card: {peaks}, drawing {draw_peak}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _serve_mesh_cut(arch, mesh):
    """``arch`` cut to SERVE_4_CUT_LAYERS layers at full width in bf16 on
    ``mesh`` and whole on cuda:0: how far the prefill logits part and
    how many greedy tokens agree, printed (the f32 cut holds the
    mesh)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.sharding import gather_params

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=SERVE_4_CUT_LAYERS)
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    print(f"phase 15b: {arch} reduced: " + json.dumps({
        "num_layers": [full.num_layers, cfg.num_layers],
        "param_count": [full.param_count(), cfg.param_count()],
        "why": f"the whole model on cuda:0 is the reference; the cut keeps "
               f"the first {cfg.num_layers} layers ({n_attn} attention, "
               f"{cfg.num_layers - n_attn} Mamba, {n_moe} MoE)"}))
    B, P, S = SERVE_4_ROWS, SERVE_4_PROMPT, SERVE_4_CACHE
    pre_shape = ShapeConfig("serve", S, B, "prefill")
    dec_shape = ShapeConfig("serve", S, B, "decode")
    gc.collect()
    torch.cuda.empty_cache()
    sharded = _init_on_mesh(cfg, mesh, LM_SEED + 1)
    whole = gather_params(sharded, "cuda:0")
    batch = _serve_prompt(cfg, B, P)
    pos = torch.full((B,), P, device="cuda:0")
    one = (steps.make_prefill_step(cfg, pre_shape),
           steps.make_decode_step(cfg, dec_shape))
    on_mesh = (steps.build_step(cfg, pre_shape, mesh).fn,
               steps.build_step(cfg, dec_shape, mesh).fn)
    launches = {"flash_attention": 0, "ssd_chunk": 0}
    runs = []

    def run(fns, params, sync=None):
        out, toks, pre, _, _ = _serve(*fns, params, batch, pos, SERVE_4_STEPS,
                                      sync=sync)
        for name in launches:
            launches[name] += pre[name]
        runs.append((out, toks))

    with ops.use_pallas_scoped(True):
        run(one, whole)
        del whole
        run(on_mesh, sharded, lambda: _sync_all(mesh))
        del sharded

    (want, want_toks), (got, toks) = runs
    err = float((got[0] - want[0]).abs().max() / want[0].abs().max())
    agree = sum(int((x == y).sum()) for x, y in zip(toks, want_toks))
    first = next((i for i, (x, y) in enumerate(zip(toks, want_toks))
                  if not torch.equal(x, y)), None)
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    print(f"phase 15b: {arch} cut to {cfg.num_layers} layers in "
          f"{cfg.compute_dtype}, {mesh.sizes} vs whole on cuda:0 (printed, "
          f"not held): prefill "
          f"logits {err:.3e} of the largest, greedy tokens agreeing {agree}"
          f" of {B * SERVE_4_STEPS}"
          + ("" if first is None else f", first parting at step {first}")
          + f"; finite logits: {finite}")
    if not finite:
        raise AssertionError(f"phase 15b: {arch} cut: logits not finite")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _serve_mesh_f32(arch, mesh, phase="15b"):
    """``arch`` at full width in f32, cut to SERVE_4_F32_LAYERS layers (the
    encoder-decoder whole), on ``mesh`` and whole on cuda:0: the prefill
    and every decode step's logits within max(LIMIT_LOGIT_REL,
    SERVE_ULP_FACTOR x the whole model's own parting one ulp away), the
    mesh and the nudged run fed the one-card run's greedy tokens."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.sharding import gather_params

    full = get_config(arch)
    cfg = dataclasses.replace(
        full, num_layers=SERVE_4_F32_LAYERS.get(arch, full.num_layers),
        param_dtype="float32", compute_dtype="float32")
    B, P, S, _ = _serve_sizes(cfg)
    pre_shape = ShapeConfig("serve", S, B, "prefill")
    dec_shape = ShapeConfig("serve", S, B, "decode")
    gc.collect()
    torch.cuda.empty_cache()
    sharded = _init_on_mesh(cfg, mesh, LM_SEED + 2)
    whole = gather_params(sharded, "cuda:0")
    batch = _serve_prompt(cfg, B, P)
    pos = _serve_pos(cfg, B, P)
    one_card = (steps.make_prefill_step(cfg, pre_shape),
                steps.make_decode_step(cfg, dec_shape))
    with ops.use_pallas_scoped(True):
        want, toks, one, _, _ = _serve(*one_card, whole, batch, pos,
                                       SERVE_REDUCED_STEPS)
        _nudge_one_ulp_on_card(whole, LM_SEED)
        nudged, _, ulp, _, _ = _serve(*one_card, whole, batch, pos,
                                      SERVE_REDUCED_STEPS, feed=toks)
        del whole
        got, _, two, _, _ = _serve(
            steps.build_step(cfg, pre_shape, mesh).fn,
            steps.build_step(cfg, dec_shape, mesh).fn, sharded, batch, pos,
            SERVE_REDUCED_STEPS, sync=lambda: _sync_all(mesh), feed=toks)

    def parting(runs):
        return [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(runs, want)]

    errs, ulp_errs = parting(got), parting(nudged)
    limit = max(LIMIT_LOGIT_REL, SERVE_ULP_FACTOR * max(ulp_errs))
    depth = (f"{cfg.num_encoder_layers} + {cfg.num_layers}"
             if cfg.is_encoder_decoder else f"{cfg.num_layers}")
    print(f"phase {phase}: {arch} in f32 at full width, {depth} layers "
          f"({cfg.param_count() / 1e9:.3f}e9 parameters), "
          f"{mesh.sizes} vs whole on cuda:0: prefill logits {errs[0]:.3e}, "
          f"{SERVE_REDUCED_STEPS} decode steps at most {max(errs[1:]):.3e} "
          f"of the largest; the whole model one ulp away: "
          f"{ulp_errs[0]:.3e}, at most {max(ulp_errs[1:]):.3e}; limit "
          f"max({LIMIT_LOGIT_REL:.0e}, {SERVE_ULP_FACTOR} x "
          f"{max(ulp_errs):.3e}) = {limit:.3e}; B9 "
          f"{two['flash_attention']} and B10 {two['ssd_chunk']} launches a "
          f"prefill (one card: {one['flash_attention']} and "
          f"{one['ssd_chunk']})")
    if not max(errs) <= limit:
        raise AssertionError(f"phase {phase}: {arch} in f32: the mesh parts "
                             f"from one card: {errs}")
    del sharded
    gc.collect()
    torch.cuda.empty_cache()
    return {name: one[name] + ulp[name] + two[name]
            for name in ("flash_attention", "ssd_chunk")}


def _nudge_one_ulp_on_card(params, seed):
    """:func:`nudge_one_ulp` for an f32 tree on the card, leaf by leaf:
    each entry moved to its next float up or down (a seeded coin)."""
    import torch
    from repro_torch.tree import leaves

    with torch.no_grad():
        for i, p in enumerate(leaves(params)):
            g = torch.Generator(device=p.device).manual_seed(seed * 7919 + i)
            up = torch.rand(p.shape, generator=g, device=p.device) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf,
                                                   -torch.inf)))
            del up


def _four_cards(phase):
    """Whether MESH_4_CARDS cards are visible; prints why not."""
    import torch

    visible = torch.cuda.device_count()
    if visible < MESH_4_CARDS:
        print(f"phase {phase}: not run: it needs {MESH_4_CARDS} cards, "
              f"{visible} visible")
    return visible >= MESH_4_CARDS


def phase15b():
    """With four cards: SERVE_4 at full width and depth, then cut in
    depth against the whole cut model on cuda:0.  Returns the B9 and B10
    launches; with fewer cards one line says (b) was not run."""
    from repro_torch.launch.mesh import make_test_mesh

    launches = {"flash_attention": 0, "ssd_chunk": 0}
    if not _four_cards("15b"):
        return launches
    for arch, (data, model) in SERVE_4:
        mesh = make_test_mesh(data, model, device="cuda:0")
        for run in (_serve_mesh_full, _serve_mesh_cut, _serve_mesh_f32):
            for name, n in run(arch, mesh).items():
                launches[name] += n
    return launches


def phase15c():
    """With four cards: SERVE_4C (MLA and the encoder-decoder) at full
    width in bf16, then in f32 against one card.  Returns the B9 and B10
    launches; with fewer cards one line says (c) was not run."""
    from repro_torch.launch.mesh import make_test_mesh

    launches = {"flash_attention": 0, "ssd_chunk": 0}
    if not _four_cards("15c"):
        return launches
    for arch, (data, model), layers in SERVE_4C:
        mesh = make_test_mesh(data, model, device="cuda:0")
        runs = (_serve_mesh_full(arch, mesh, "15c", layers),
                _serve_mesh_f32(arch, mesh, "15c"))
        for got in runs:
            for name, n in got.items():
                launches[name] += n
    return launches


def _long_caches(cfg, rows, seed):
    """A batch-1 decode cache of ``rows`` rows on cuda:0, every KV entry
    drawn from ``seed`` (the rows a prompt of ``rows`` tokens would have
    written)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    caches = T.init_lm_cache(cfg, 1, rows, device="cuda:0")
    gen = torch.Generator(device="cuda:0").manual_seed(seed)
    for t in leaves(caches):
        t.normal_(generator=gen)
    return caches


def _long_decode(decode, params, caches, token, sync):
    """LONG_STEPS greedy decode steps from each of LONG_STARTS: (every
    step's logits, the tokens fed, ms a step at each start)."""
    out, toks, ms = [], [], []
    for start in LONG_STARTS:
        sync()
        t0 = time.perf_counter()
        tok = token
        for i in range(LONG_STEPS):
            toks.append(tok)
            logits, caches = decode(params, caches, tok, start + i)
            out.append(logits)
            tok = logits.argmax(-1, keepdim=True)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3 / LONG_STEPS)
    return out, toks, ms


def _serve_long(mesh, dtype, layers=None, profile=False):
    """LONG_ARCH at ``dtype`` (depth cut to ``layers`` where given),
    batch 1 at LONG_SHAPE: a cache whose rows are drawn from the seed,
    decoded whole on cuda:0 from a seeded token, then on ``mesh`` (its
    sequence cut over (data, model)) from the same entries, fed one
    card's tokens; with ``profile``, one more step from LONG_STARTS[0]
    under the profiler on each (``profile_device``: host launches and
    idle share).  Returns (the mesh's logits, one card's, the steps
    whose greedy tokens agree)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import steps
    from repro_torch.models import sharding as SH
    from repro_torch.models.sharding import gather_params

    full = get_config(LONG_ARCH)
    cfg = dataclasses.replace(full, param_dtype=dtype, compute_dtype=dtype,
                              num_layers=layers or full.num_layers)
    shape = SHAPES[LONG_SHAPE]
    rows = shape.seq_len
    cards = list(dict.fromkeys(mesh.devices))
    gc.collect()
    torch.cuda.empty_cache()
    for dev in cards:
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sharded = _init_on_mesh(cfg, mesh, LM_SEED + 3)
    whole = gather_params(sharded, "cuda:0")
    caches = _long_caches(cfg, rows, LM_SEED + 4)
    placed = SH.shard_cache(caches, mesh, 1)
    spec = SH.cache_pspecs(caches, mesh, 1)[0]["k"]
    token = _tensor_cuda([[7]])
    one_step = steps.make_decode_step(cfg, shape)
    one, one_toks, one_ms = _long_decode(one_step, whole, caches, token,
                                         torch.cuda.synchronize)
    if profile:
        profile_device("15d", f"{LONG_ARCH} decode step from "
                       f"{LONG_STARTS[0]}, one card", lambda: one_step(
                           whole, caches, one_toks[0], LONG_STARTS[0]),
                       host_top=3)
    del whole, caches
    gc.collect()
    torch.cuda.empty_cache()
    feed = iter(one_toks)
    decode = steps.build_step(cfg, shape, mesh).fn
    got, _, ms = _long_decode(
        lambda p, c, tok, pos: decode(p, c, next(feed), pos),
        sharded, placed, token, lambda: _sync_all(mesh))
    if profile:
        profile_device("15d", f"{LONG_ARCH} decode step from "
                       f"{LONG_STARTS[0]}, {mesh.sizes}", lambda: decode(
                           sharded, placed, one_toks[0], LONG_STARTS[0]),
                       host_top=3)
    agree = sum(int(torch.equal(a.argmax(-1), b.argmax(-1)))
                for a, b in zip(got, one))
    window = steps.decode_window(cfg, shape)
    peaks = ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 2**30:.2f}"
                      for d in cards)
    cache_gb = (2 * cfg.num_layers * rows * cfg.num_kv_heads * cfg.head_dim
                * (2 if dtype == "bfloat16" else 4) / 1e9)
    print(f"phase 15d: {LONG_ARCH} in {dtype}, {cfg.num_layers} layers, "
          f"batch 1, a {rows}-row cache ({cache_gb:.2f} GB, drawn from the "
          f"seed; the k spec {spec}, "
          f"window {window}) on {mesh.sizes}: {LONG_STEPS} decode steps "
          f"from each of {LONG_STARTS}: the mesh {[round(t, 3) for t in ms]}"
          f" ms a step, one card {[round(t, 3) for t in one_ms]} (host "
          f"clock ending in a synchronize of every card); peak GiB by card "
          f"(one card's copy on cuda:0 included): {peaks}")
    del sharded, placed
    gc.collect()
    torch.cuda.empty_cache()
    return got, one, agree


def phase15d():
    """With four cards: LONG_ARCH's batch-1 LONG_SHAPE decode over (2, 2),
    its cache's sequence cut over (data, model), fed one card's tokens:
    bf16 at full width and depth against one card, printed; an f32 cut
    of LONG_F32_LAYERS layers held within LIMIT_LOGIT_REL.  With fewer
    cards one line says (d) was not run."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh

    if not _four_cards("15d"):
        return
    mesh = make_test_mesh(2, 2, device="cuda:0")
    got, want, agree = _serve_long(mesh, "bfloat16", profile=True)
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    print(f"phase 15d: {LONG_ARCH} bf16 at full width, (2, 2) vs one card "
          f"fed its tokens (printed, not held): logits at most "
          f"{max(errs):.3e} of the largest (first step of each start "
          f"{errs[0]:.3e}, {errs[LONG_STEPS]:.3e}), greedy tokens agreeing "
          f"at {agree} of {len(got)} steps; finite logits: {finite}")
    if not finite:
        raise AssertionError("phase 15d: bf16 logits not finite")
    got, want, _ = _serve_long(mesh, "float32", LONG_F32_LAYERS)
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    print(f"phase 15d: {LONG_ARCH} in f32 cut to {LONG_F32_LAYERS} layers, "
          f"(2, 2) vs one card fed its tokens: logits at most "
          f"{max(errs):.3e} of the largest (limit {LIMIT_LOGIT_REL:.0e})")
    if not max(errs) <= LIMIT_LOGIT_REL:
        raise AssertionError(f"phase 15d: f32 parts from one card: {errs}")


def phase15():
    """Serving over a data x model mesh.  Returns the B9 and B10
    launches."""
    launches = phase15a()
    for part in (phase15b, phase15c):
        for name, n in part().items():
            launches[name] += n
    phase15d()
    return launches


# -- phase 16, the dry run against the cards -------------------------------

DRY_TRAIN_1 = "gemma-2b"                        # phase 11a's step
DRY_TRAIN_4 = ("qwen2-7b", (2, 2))              # phase 13c's
DRY_SERVE_4 = ("llama4-scout-17b-a16e", (1, 4))   # phase 15b's
LIMIT_DRY_ARGS_REL = 0.01      # bytes after placement, by card
LIMIT_DRY_PEAK_REL = 0.10      # a training step's peak, by card


def _dry_count(cfg, shape, sizes):
    """The dry run of ``cfg``'s step at ``shape`` on a fake (data,
    model) mesh of ``sizes``: a ``StepCount``, one entry a device, and
    the host seconds it took (placement and run)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh

    t0 = time.perf_counter()
    mesh = make_test_mesh(*sizes, device="meta")
    lowered = steps.lower_step(steps.build_step(cfg, shape, mesh), mesh)
    return lowered.run(), time.perf_counter() - t0


def _train_shape():
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("custom_train", TRAIN_SEQ, TRAIN_BATCH, "train",
                       TRAIN_MICRO)


def _serve_shape(cfg):
    from repro_torch.configs.base import ShapeConfig
    B, _, S, _ = _serve_sizes(cfg)
    return ShapeConfig("serve", S, B, "decode")


def _dry_job(arch, kind, sizes):
    """A dry run in a worker process: phase 16's train or serve step of
    ``arch`` at full width."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    shape = _train_shape() if kind == "train" else _serve_shape(cfg)
    return _dry_count(cfg, shape, sizes)


def _held(phase, label, card, dry, limit):
    """Each card's bytes against the dry run's, GiB, printed; raises past
    ``limit`` (relative) where ``limit`` is given."""
    errs = [abs(c - d) / d for c, d in zip(card, dry)]
    print(f"phase {phase}: {label} by card: card " + ", ".join(
        f"{c / 2**30:.3f}" for c in card) + " GiB; dry run " + ", ".join(
        f"{d / 2**30:.3f}" for d in dry) + f" GiB; worst {max(errs):.4%}"
        + ("" if limit is None else f" (limit {limit:.0%})"))
    if limit is not None and not max(errs) <= limit:
        raise AssertionError(f"phase {phase}: {label}: the dry run is "
                             f"{max(errs):.4%} off the card")


def _train_batch_on(cfg, B, S, device):
    """A (B, S) int32 token batch from the seed, as ``batch_specs``."""
    import torch

    g = torch.Generator(device=device).manual_seed(LM_SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=device, dtype=torch.int32)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def _dry_train(phase, arch, sizes, dry_run, copies):
    """``arch``'s full-width training step (phase 11a's batch) placed by
    its bundle and run once on (data, model) = ``sizes`` cards, against
    ``dry_run()`` (its ``StepCount`` and host seconds); ``copies``: run
    under the dry run's counter and hold the cross-card bytes it counts
    equal to the dry run's."""
    import gc
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.roofline.analysis import collective_bytes
    from repro_torch.roofline.counting import StepCounter

    cfg = get_config(arch)
    shape = _train_shape()
    mesh = make_test_mesh(*sizes, device="cuda:0")
    cards = mesh.devices
    gc.collect()
    torch.cuda.empty_cache()
    base = [torch.cuda.memory_allocated(d) for d in cards]
    bundle = steps.build_step(cfg, shape, mesh)
    whole = T.init_lm(torch.Generator(device=cards[0]).manual_seed(LM_SEED),
                      cfg, device=cards[0])
    args = bundle.place((whole, None, None, _train_batch_on(
        cfg, TRAIN_BATCH, TRAIN_SEQ, cards[0])))
    del whole
    gc.collect()
    _sync_all(mesh)
    placed = [torch.cuda.memory_allocated(d) - b for d, b in zip(cards, base)]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    counter = StepCounter(cards)
    t0 = time.perf_counter()
    with counter if copies else contextlib.nullcontext():
        out = bundle.fn(*args)
    _sync_all(mesh)
    step_s = time.perf_counter() - t0
    peaks = [torch.cuda.max_memory_allocated(d) - b
             for d, b in zip(cards, base)]
    loss = float(out[2]["loss"])
    dry, dry_s = dry_run()
    label = f"{arch} train step at {sizes}"
    print(f"phase {phase}: {label}: {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
          f"{steps.num_microbatches(cfg, shape, len(mesh.replicas))} "
          f"microbatches; loss {loss!r}; the card's step {step_s:.3f} s"
          f"{' under the counter' if copies else ''}; the dry run "
          f"{dry_s:.1f} s on the host")
    _held(phase, f"{label}: bytes after placement", placed,
          dry.argument_bytes, LIMIT_DRY_ARGS_REL)
    _held(phase, f"{label}: peak over the step", peaks, dry.peak_bytes,
          LIMIT_DRY_PEAK_REL)
    if not math.isfinite(loss):
        raise AssertionError(f"phase {phase}: {label}: loss {loss}")
    if copies:
        got = counter.result()
        card, fake = collective_bytes(got), collective_bytes(dry)
        kinds = sorted(set(card["counts"]) | set(fake["counts"]))
        print(f"phase {phase}: {label}: cross-card bytes (copies) by kind, "
              f"card / dry run: " + ", ".join(
                  f"{k} {card.get(k, 0):.0f} ({card['counts'].get(k, 0)}) / "
                  f"{fake.get(k, 0):.0f} ({fake['counts'].get(k, 0)})"
                  for k in kinds))
        if got.copies != dry.copies:
            raise AssertionError(f"phase {phase}: {label}: the cross-card "
                                 f"copies differ: card {card['pairs']}, dry "
                                 f"run {fake['pairs']}")
    del args, out, bundle
    gc.collect()
    torch.cuda.empty_cache()


def _dry_serve(phase, arch, sizes, dry_run):
    """``arch``'s full-width decode step over phase 15b's cache on
    (data, model) = ``sizes`` cards, parameters drawn layer by layer
    onto the mesh: bytes after placement held against ``dry_run()``'s,
    the step's peak printed beside it."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharding as SH

    cfg = get_config(arch)
    B, P, S, _ = _serve_sizes(cfg)
    shape = _serve_shape(cfg)
    mesh = make_test_mesh(*sizes, device="cuda:0")
    cards = mesh.devices
    gc.collect()
    torch.cuda.empty_cache()
    base = [torch.cuda.memory_allocated(d) for d in cards]
    params = _init_on_mesh(cfg, mesh, LM_SEED)
    caches = SH.shard_cache(steps.cache_specs(cfg, B, S), mesh, B)
    token = torch.zeros((B, 1), dtype=torch.int32, device=cards[0])
    pos = _serve_pos(cfg, B, P)
    _sync_all(mesh)
    placed = [torch.cuda.memory_allocated(d) - b for d, b in zip(cards, base)]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    decode = steps.build_step(cfg, shape, mesh).fn
    logits, caches = decode(params, caches, token, pos)
    _sync_all(mesh)
    peaks = [torch.cuda.max_memory_allocated(d) - b
             for d, b in zip(cards, base)]
    dry, dry_s = dry_run()
    label = f"{arch} decode step at {sizes} ({B} rows, {S}-row cache)"
    print(f"phase {phase}: {label}: finite logits "
          f"{bool(torch.isfinite(logits).all())}; the dry run {dry_s:.1f} s "
          f"on the host")
    _held(phase, f"{label}: bytes after placement", placed,
          dry.argument_bytes, LIMIT_DRY_ARGS_REL)
    _held(phase, f"{label}: serving peak (not held)", peaks,
          dry.peak_bytes, None)
    del params, caches, logits
    gc.collect()
    torch.cuda.empty_cache()


def phase16():
    """The dry run against the cards (see the module docstring, 16).  The
    dry runs go on in worker processes (spawned, one each) while the
    cards run the same steps."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    print(f"phase 16: {card_line()}")
    four = all([_four_cards("16b"), _four_cards("16c")])
    jobs = {"16a": (DRY_TRAIN_1, "train", (1, 1))}
    if four:
        jobs["16b"] = (DRY_TRAIN_4[0], "train", DRY_TRAIN_4[1])
        jobs["16c"] = (DRY_SERVE_4[0], "serve", DRY_SERVE_4[1])
    with ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        runs = {k: pool.submit(_dry_job, *job) for k, job in jobs.items()}
        _dry_train("16a", DRY_TRAIN_1, (1, 1), runs["16a"].result,
                   copies=False)
        if four:
            _dry_train("16b", *DRY_TRAIN_4, runs["16b"].result, copies=True)
            _dry_serve("16c", *DRY_SERVE_4, runs["16c"].result)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s on the host")


def path_data():
    """(x, labels, gamma): the cohort server's N=10⁵ blobs on the host and
    the RBF width the server picks for them (on the card)."""
    import numpy as np
    import torch
    from repro_torch.core.kmeans import pairwise_sq_dists
    from repro_torch.core.spectral import auto_gamma

    x, labels = blobs(np.random.default_rng(SEED))
    xt = torch.tensor(x, device="cuda")
    return x, labels, float(auto_gamma(pairwise_sq_dists(xt[:4096],
                                                         xt[:M])))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    phase1()
    x, labels, gamma = path_data()
    records = phase2(x, gamma)
    records.update(phase2_m4096(x, gamma))
    records.update(phase2_slice2(x, gamma))
    records.update(phase2_lm())
    launches = phase3(x, labels)
    launches["pairwise_sq_dists"] = phase4()
    launches.update(phase5(x, labels))
    launches.update(phase6())
    for name, n in phase7(x, labels).items():
        launches[name] += n
    for name, n in phase8a(x, labels).items():
        launches[name] += n
    for name, n in phase8b().items():
        launches[name] += n
    for name, n in phase9().items():
        launches[name] += n
    launches["flash_attention"] += phase10()
    _, first_loss = phase11()
    phase12(first_loss[MESH_FULL_ARCH])
    phase13(first_loss[TP_FULL_ARCH])
    phase14()
    for name, n in phase15().items():
        launches[name] += n
    phase16()
    for name, rec in records.items():
        rec["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{key: records[name][key] for key in keys}
                                  for name in (*KERNELS, *EXTRA_ROWS,
                                               B7_DENSE)]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
