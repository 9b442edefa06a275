"""CohortEngine — the select–cluster–cache lifecycle, in PyTorch.

Port of the JAX package's ``cohort/engine.py`` with the same public API:
``CohortEngine(config, seed=..., device=..., mesh=...)``,
``engine.select(embeds) -> CohortResult``, ``prepare`` / ``publish``,
``reset()``, ``stats``.

* **method resolution** — ``dense`` below ``dense_cutoff`` clients, the
  mesh route (``"sharded"``, ``cohort/sharded.py``) above it: client
  rows spread over ``mesh``, a tuple of devices (default
  ``launch.mesh.make_cohort_mesh(device=device)``: every visible card,
  the engine's first; the CPU alone on the CPU).  On one device it is
  the single-device ``"nystrom"`` solve bit for bit.
* **determinism** — every solve draws its landmarks, k-means++ seeds and
  subspace ranges from CPU ``torch.Generator``s seeded from ``(seed,
  fingerprint(embeds)[:4])``, and the kernels sum in a fixed order, so
  a cold solve is a pure function of ``(seed, embeds)`` — and a solve on
  the card uses the same landmarks as the same solve on the CPU.
* **caching and warm starts** — an exact content fingerprint
  short-circuits repeated solves; a moment/sign-weighted sketch measures
  drift against the last cold solve, and below ``drift_threshold`` the
  engine reuses that solve's landmarks + bandwidth and warm-starts the
  subspace solvers from the persisted eigenbases in ``CohortState``.
* **device** — ``"cuda"`` unless ``device`` says otherwise; with no GPU
  and no ``device="cpu"`` the constructor raises.  Results come back as
  numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.cohort.eigensolver import load_linalg
from repro_torch.cohort.landmarks import LANDMARK_STRATEGIES, select_landmarks
from repro_torch.cohort.nystrom import nystrom_from_landmarks
from repro_torch.cohort.sharded import sharded_nystrom_from_landmarks
from repro_torch.core import spectral as _spectral
from repro_torch.core.kmeans import kmeans, pairwise_sq_dists
from repro_torch.core.spectral import row_normalize
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import as_mesh, make_cohort_mesh

_METHODS = ("auto", "dense", "nystrom", "sharded")
_SKETCH_EPS = 1e-12
# autotuning only ever reads the last two gaps; keep a short tail for
# debugging but never let a long-running server grow the list unboundedly
_GAP_HIST_MAX = 32

# landmark-count autotuning (num_landmarks="auto"): relative eigengap
# g = (λ_{k+1} − λ_k) / (λ_{k+1} − λ_1); below _GAP_WEAK m doubles, above
# _GAP_STRONG twice in a row with moderate drift it halves
_GAP_WEAK = 0.02
_GAP_STRONG = 0.08
_AUTO_M_MAX_FACTOR = 8     # cap: 8x the static default, clipped to n
_AUTO_M_DRIFT_FACTOR = 4   # shrink only when drift <= 4x drift_threshold


@dataclasses.dataclass
class CohortConfig:
    """Knobs of the cohort-selection engine (see module docstring).

    num_clusters     — k: spectral-embedding width and DQN action count.
    method           — "auto" | "dense" | "nystrom" | "sharded".
    num_landmarks    — m: an int pins it, None uses max(8k, 64), "auto"
                       autotunes m between that default and 8x it.
    landmarks        — "uniform" | "leverage" | "kmeans++" strategy.
    solver           — landmark eigenproblems: "auto" picks dense eigh
                       for m <= eigh_cutoff, blocked subspace iteration
                       above; "eigh" / "subspace" pin it.
    dense_solver     — dense-path eigensolver ("eigh" | "subspace").
    auto_k           — eigengap heuristic caps the cluster count k̂ <= k.
    warm_start       — enable drift-gated incremental re-clustering.
    drift_threshold  — relative sketch distance below which the previous
                       round's landmarks/bandwidth/eigenbases are reused.
    cold_iters/warm_iters — subspace sweeps from random / persisted q0.
    dense_cutoff     — "auto" method: largest N solved densely.
    eigh_cutoff      — "auto" solver: largest m factored with dense eigh.
    w_rank           — rank of the blocked W^{-1/2} (default max(8k, 64)).
    block_rows       — row-panel height inside the blocked eigensolver.
    use_pallas       — route the solve through the hand-written kernels
                       (CUDA on the card): the dense path's pairwise
                       distances, and the landmark paths' fused passes
                       (the (N, m) cross-affinity is never
                       materialized) and subspace panel products.
    affinity_dtype   — "f32" | "bf16" | "int8": tile precision of the
                       fused affinity passes.  Non-f32 requires
                       use_pallas=True.
    """
    num_clusters: int = 8
    method: str = "auto"
    num_landmarks: Optional[object] = None     # int | None | "auto"
    landmarks: str = "uniform"
    solver: str = "auto"
    dense_solver: str = "eigh"
    auto_k: bool = False
    warm_start: bool = True
    drift_threshold: float = 0.05
    cold_iters: int = 40
    warm_iters: int = 8
    dense_cutoff: int = 2048
    eigh_cutoff: int = 2048
    w_rank: Optional[int] = None
    block_rows: int = 2048
    use_pallas: bool = False
    affinity_dtype: str = "f32"

    def __post_init__(self):
        if self.affinity_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"unknown affinity_dtype {self.affinity_dtype!r}; "
                f"expected one of ('f32', 'bf16', 'int8')")
        if self.affinity_dtype != "f32" and not self.use_pallas:
            raise ValueError(
                f"affinity_dtype={self.affinity_dtype!r} requires "
                f"use_pallas=True (quantized tiles only exist in the "
                f"fused kernel pipeline)")
        if self.method not in _METHODS:
            raise ValueError(f"unknown method {self.method!r}; "
                             f"expected one of {_METHODS}")
        if self.landmarks not in LANDMARK_STRATEGIES:
            raise ValueError(
                f"unknown landmark strategy {self.landmarks!r}; "
                f"expected one of {LANDMARK_STRATEGIES}")
        if self.solver not in ("auto", "eigh", "subspace"):
            raise ValueError(f"unknown solver {self.solver!r}")
        m = self.num_landmarks
        if not (m is None or m == "auto"
                or (isinstance(m, (int, np.integer)) and m > 0)):
            raise ValueError(
                f"num_landmarks={m!r} must be a positive int, None, "
                f"or \"auto\"")


@dataclasses.dataclass
class CohortState:
    """Engine-owned per-round memory: the warm-start payload."""
    fingerprint: Optional[bytes] = None
    sketch: Optional[np.ndarray] = None
    num_clients: int = 0
    landmark_idx: Optional[np.ndarray] = None
    gamma: Optional[float] = None
    w_basis: Optional[np.ndarray] = None
    mm_basis: Optional[np.ndarray] = None
    result: Optional["CohortResult"] = None


@dataclasses.dataclass
class CohortResult:
    """One cohort clustering: assignments plus provenance."""
    assign: np.ndarray            # (n,) cluster ids in [0, k)
    k: int                        # clusters actually used (k̂ if auto_k)
    embedding: np.ndarray         # (n, k) row-normalized spectral embedding
    evals: np.ndarray             # approximate L_norm spectrum, ascending
    method: str                   # resolved: dense | nystrom | sharded
    source: str                   # "cold" | "warm" | "cache"
    drift: float                  # relative sketch drift vs last cold baseline
    seconds: float                # wall time of this solve (0 on cache hit)


@dataclasses.dataclass
class PreparedSolve:
    """A finished solve staged for publication (the solve-ahead payload)."""
    fingerprint: bytes
    sketch: np.ndarray
    num_clients: int
    result: CohortResult
    landmark_idx: Optional[np.ndarray]
    gamma: Optional[float]
    w_basis: Optional[np.ndarray]
    mm_basis: Optional[np.ndarray]
    warm: bool                    # warm-started off the state it saw
    drift: float
    # k+1-wide L_norm spectrum for the landmark autotuner (only set for
    # cold landmark solves under num_landmarks="auto")
    auto_m_evals: Optional[np.ndarray] = None


def solve_generators(seed: int, fp: bytes):
    """CPU generators (landmarks, solver, k-means) of one solve.

    Seeded from ``(seed, fingerprint[:4])`` — the counterpart of the JAX
    engine's ``fold_in(PRNGKey(seed), fp[:4])`` split three ways.
    """
    seq = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int.from_bytes(fp[:4], "little")])
    return tuple(torch.Generator().manual_seed(int(s))
                 for s in seq.generate_state(3, np.uint64))


class CohortEngine:
    """Owns the full select–cluster–cache lifecycle for cohort selection.

    ``select(embeds)`` clusters the (N, d) client embeddings and returns
    a :class:`CohortResult`.  Determinism contract: every COLD solve is a
    pure function of ``(seed, embeds)``.  Warm starts reuse the previous
    round's landmarks; they fire only below ``drift_threshold`` and can be
    disabled with ``warm_start=False``.
    """

    def __init__(self, config: Optional[CohortConfig] = None, *,
                 seed: int = 0, device=None, mesh=None):
        self.config = config or CohortConfig()
        self.device = resolve_device(device)
        # before any serving thread: the first CUDA eigh is not thread-safe
        load_linalg(self.device)
        self._mesh = None if mesh is None else as_mesh(mesh)
        self.seed = int(seed)
        self._sketch_sign: Optional[np.ndarray] = None
        self._sketch_seed = seed ^ 0x5EED
        self.state = CohortState()
        self._auto_m: Optional[int] = None     # autotuned landmark count
        self._gap_hist: "collections.deque" = collections.deque(
            maxlen=_GAP_HIST_MAX)
        self.stats = {"solves": 0, "cache_hits": 0, "warm_starts": 0,
                      "cold_starts": 0, "probes": 0,
                      "batched_selects": 0, "coalesced_requests": 0}

    # -- state ----------------------------------------------------------
    def reset(self) -> None:
        """Drop all cached/warm-start state (e.g. on client churn)."""
        self.state = CohortState()

    @staticmethod
    def fingerprint(embeds: np.ndarray) -> bytes:
        """Content fingerprint of an embedding table (shape-qualified)."""
        h = hashlib.sha1(np.ascontiguousarray(embeds).tobytes())
        h.update(str(embeds.shape).encode())
        return h.digest()

    def _sketch(self, embeds: np.ndarray) -> np.ndarray:
        """O(n·d) drift probe: column moments + a sign-weighted row sum."""
        n = embeds.shape[0]
        if self._sketch_sign is None or len(self._sketch_sign) != n:
            rng = np.random.default_rng(self._sketch_seed)
            self._sketch_sign = rng.choice(
                np.array([-1.0, 1.0], np.float32), size=n)
        return np.concatenate([
            embeds.mean(axis=0), embeds.std(axis=0),
            (self._sketch_sign[:, None] * embeds).mean(axis=0)])

    # -- resolution -----------------------------------------------------
    def _resolve_method(self, n: int) -> str:
        if self.config.method != "auto":
            return self.config.method
        if n <= self.config.dense_cutoff:
            return "dense"
        return "sharded"

    def _resolve_solver(self, m: int) -> str:
        if self.config.solver != "auto":
            return self.config.solver
        return "eigh" if m <= self.config.eigh_cutoff else "subspace"

    def _cohort_mesh(self):
        if self._mesh is None:
            self._mesh = make_cohort_mesh(device=self.device)
        return self._mesh

    # -- solve ----------------------------------------------------------
    def select(self, embeds, *, key: Optional[int] = None) -> CohortResult:
        """Cluster the (N, d) client embeddings; cache- and drift-aware.

        ``key`` (an int) replaces the content-derived seed: the call is a
        one-off probe that bypasses the fingerprint cache, leaves the
        cache/warm-start state untouched and counts under
        ``stats["probes"]`` only.
        """
        embeds = np.ascontiguousarray(np.asarray(embeds, np.float32))
        st = self.state
        fp = self.fingerprint(embeds)
        persist = key is None
        if persist and st.fingerprint == fp and st.result is not None:
            self.stats["cache_hits"] += 1
            cached = st.result
            return dataclasses.replace(
                cached, source="cache", seconds=0.0,
                assign=cached.assign.copy(),
                embedding=cached.embedding.copy(),
                evals=cached.evals.copy())
        prep = self._prepare(embeds, fp, key=key, warm_ok=persist)
        if persist:
            self.publish(prep)
        else:
            self.stats["probes"] += 1
        return prep.result

    def prepare(self, embeds) -> Optional[PreparedSolve]:
        """Solve without mutating serving-visible caches (or None if the
        cache is already current for these exact embeddings)."""
        embeds = np.ascontiguousarray(np.asarray(embeds, np.float32))
        fp = self.fingerprint(embeds)
        if self.state.fingerprint == fp and self.state.result is not None:
            return None
        return self._prepare(embeds, fp, key=None, warm_ok=True)

    def publish(self, prep: PreparedSolve, *, count: bool = True,
                ) -> CohortResult:
        """Install a staged solve as the engine's current state."""
        st = self.state
        st.fingerprint, st.num_clients = prep.fingerprint, prep.num_clients
        if not prep.warm:
            st.sketch = prep.sketch          # new cold baseline
        st.landmark_idx = prep.landmark_idx
        st.gamma = prep.gamma
        st.w_basis = prep.w_basis
        st.mm_basis = prep.mm_basis
        st.result = prep.result
        if count:
            self.stats["warm_starts" if prep.warm else "cold_starts"] += 1
            self.stats["solves"] += 1
            if prep.auto_m_evals is not None:
                self._update_auto_m(prep.num_clients,
                                    self.config.num_clusters,
                                    prep.drift, prep.auto_m_evals)
        return prep.result

    def _prepare(self, embeds: np.ndarray, fp: bytes, *, key,
                 warm_ok: bool) -> PreparedSolve:
        """The full solve, staged: reads engine state, never writes it."""
        cfg = self.config
        st = self.state
        t0 = time.perf_counter()
        n = embeds.shape[0]
        method = self._resolve_method(n)
        if key is None:
            land_gen, solve_gen, km_gen = solve_generators(self.seed, fp)
        else:
            land_gen, solve_gen, km_gen = solve_generators(int(key), b"")

        # drift against the sketch of the last COLD solve: warm rounds do
        # not advance the baseline, so slow drift accumulates into a
        # cold refresh
        sketch = self._sketch(embeds)
        drift = float("inf")
        if st.sketch is not None and st.num_clients == n:
            drift = float(np.linalg.norm(sketch - st.sketch)
                          / (np.linalg.norm(st.sketch) + _SKETCH_EPS))

        # a copy: the table may be a read-only snapshot
        x = torch.tensor(embeds, device=self.device)
        k = cfg.num_clusters
        # auto_k and landmark autotuning read the λ_k / λ_{k+1} gap, but
        # the subspace solvers return only as many eigenvalues as the
        # embedding width: solve one wider and slice back
        widen = cfg.auto_k or (self._autotune_m and method != "dense")
        solve_k = k + 1 if widen else k
        if method == "dense":
            y, evals = self._solve_dense(x, solve_k)
            warm = False
            idx = gamma = w_basis = mm_basis = None
        else:
            y, evals, warm, idx, gamma, w_basis, mm_basis = \
                self._solve_landmarks(x, solve_k, method, drift,
                                      land_gen, solve_gen, warm_ok=warm_ok)
        evals = evals.cpu().numpy()
        auto_m_evals = (evals if self._autotune_m and method != "dense"
                        and not warm else None)

        k_hat = k
        if cfg.auto_k:
            k_hat = int(np.clip(_spectral.eigengap_k(evals, k), 2, k))
            y = row_normalize(y[:, :k_hat])
        elif widen:
            y = row_normalize(y[:, :k])
        assign, _ = kmeans(km_gen, y, k_hat)

        result = CohortResult(
            assign=assign.cpu().numpy(), k=k_hat,
            embedding=y.cpu().numpy(), evals=evals,
            method=method, source="warm" if warm else "cold", drift=drift,
            seconds=time.perf_counter() - t0)

        def host(t):
            return None if t is None else t.cpu().numpy()

        return PreparedSolve(
            fingerprint=fp, sketch=sketch, num_clients=n, result=result,
            landmark_idx=host(idx),
            gamma=None if gamma is None else float(gamma),
            w_basis=host(w_basis), mm_basis=host(mm_basis),
            warm=warm, drift=drift, auto_m_evals=auto_m_evals)

    def select_batched(self, embeds, *, requests: int = 1) -> CohortResult:
        """One solve serving ``requests`` coalesced select calls."""
        if requests < 1:
            raise ValueError(f"requests={requests} must be >= 1")
        result = self.select(embeds)
        self.stats["batched_selects"] += 1
        self.stats["coalesced_requests"] += requests
        return result

    def _solve_dense(self, x, k: int):
        a = _spectral.affinity_matrix(x, use_pallas=self.config.use_pallas)
        return _spectral.spectral_embedding(
            a, k, solver=self.config.dense_solver)

    @property
    def _autotune_m(self) -> bool:
        return self.config.num_landmarks == "auto"

    def _num_landmarks(self, n: int, k: int) -> int:
        if self._autotune_m:
            # base off the configured cluster count, not the (possibly
            # k+1-widened) solve width, so the recorded _auto_m equals
            # the m actually solved with
            m = self._auto_m or _spectral.default_num_landmarks(
                n, self.config.num_clusters)
        else:
            m = (self.config.num_landmarks
                 or _spectral.default_num_landmarks(n, k))
        m = min(int(m), n)
        if m < k:
            raise ValueError(f"num_landmarks={m} must be >= k={k}")
        return m

    def _update_auto_m(self, n: int, k: int, drift: float,
                       evals: np.ndarray) -> None:
        """Adapt the landmark count from eigengap + drift evidence."""
        evals = np.asarray(evals)
        if len(evals) <= k:           # no λ_{k+1}: nothing to measure
            return
        lo, hi = float(evals[k - 1]), float(evals[k])
        gap = max(hi - lo, 0.0) / max(hi - float(evals[0]), _SKETCH_EPS)
        self._gap_hist.append(gap)
        base = _spectral.default_num_landmarks(n, k)
        cap = min(n, _AUTO_M_MAX_FACTOR * base)
        m = self._auto_m or base
        if gap < _GAP_WEAK:
            m = min(cap, 2 * m)
        elif (len(self._gap_hist) >= 2
              and min(list(self._gap_hist)[-2:]) > _GAP_STRONG
              and np.isfinite(drift)
              and drift <= _AUTO_M_DRIFT_FACTOR
              * self.config.drift_threshold):
            m = max(base, m // 2)
        self._auto_m = m
        self.stats["auto_m"] = m

    def _solve_landmarks(self, x, k: int, method: str, drift: float,
                         land_gen, solve_gen, *, warm_ok: bool = True):
        cfg, st = self.config, self.state
        n = x.shape[0]
        m = self._num_landmarks(n, k)
        solver = self._resolve_solver(m)
        # warm = reuse the previous round's landmarks + bandwidth; with
        # subspace solvers the persisted eigenbases also seed q0.  Probes
        # (warm_ok=False) never warm-start.
        warm = (warm_ok and cfg.warm_start
                and drift <= cfg.drift_threshold
                and st.landmark_idx is not None
                and len(st.landmark_idx) == m and st.gamma is not None)
        warm_basis = (warm and solver == "subspace"
                      and st.mm_basis is not None
                      and st.w_basis is not None)
        if warm:
            idx = torch.as_tensor(st.landmark_idx, device=x.device)
            gamma = st.gamma
        else:
            idx = select_landmarks(land_gen, x, m, cfg.landmarks)
            rows = x[:min(n, _spectral._GAMMA_SAMPLE_ROWS)]
            gamma = float(_spectral.auto_gamma(
                pairwise_sq_dists(rows, x[idx])))

        def basis(arr):
            return torch.as_tensor(arr, device=x.device) if warm_basis else None

        w_rank = (None if solver == "eigh"
                  else min(m, cfg.w_rank or max(8 * k, 64)))
        kwargs = dict(
            use_pallas=cfg.use_pallas, fused=cfg.use_pallas,
            affinity_dtype=cfg.affinity_dtype, w_solver=solver,
            w_rank=w_rank, mm_solver=solver,
            iters=cfg.warm_iters if warm_basis else cfg.cold_iters,
            w_q0=basis(st.w_basis), mm_q0=basis(st.mm_basis),
            generator=solve_gen, block_rows=cfg.block_rows)
        # use_pallas routes the solve through the fused kernels
        if method == "sharded":
            y, evals, mm_basis, w_basis = sharded_nystrom_from_landmarks(
                x, idx, k, gamma, self._cohort_mesh(), **kwargs)
        else:
            y, evals, mm_basis, w_basis = nystrom_from_landmarks(
                x, idx, k, gamma, **kwargs)
        return y, evals, warm, idx, gamma, w_basis, mm_basis
