"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``perfbench/reference``) follows each tenant's engine solve
by solve over the tables the traffic sent: it finds each published
solve's table by its fingerprint, decides warm or cold itself from the
drift sketch, draws the landmarks and the bandwidth of every cold solve
itself, and solves a seed-drawn sample of the window's solves (each
tenant's first cold one among them) in float64.  It follows each
tenant's policy from its first round (``perfbench/reference/policy.py``):
the state of every select, its action values, its draw, and every TD
update, in float64.

Numbers compared, each the worst over what was compared:

* ``spectrum_gap``: the k smallest eigenvalues of the normalized
  Laplacian, largest absolute difference;
* ``embedding_gap``: the sine of the largest principal angle between
  the spans of the program's and the reference's spectral embeddings;
* ``assign_gap``: the share of rows that the program's k-means left off
  the nearest of its own clusters' centers, centers and distances taken
  in the reference's embedding (a Lloyd step's fixed point, judged
  where the embedding is right);
* ``q_gap``: the action values of every select against the
  reference's (its weights and its state), largest absolute difference
  over the largest reference value;
* ``change_gap``: the Q-network's change from its initial weights to
  its last, by the worst leaf: the gap between the program's norm and
  the reference's over the reference's norm of that leaf or of the
  median leaf, whichever is larger (leaves whose reference gradient is
  under a thousandth of the median leaf's are left out);
* ``draw_faults``, ``drift_faults``, ``stale_faults``, ``init_faults``,
  ``step_faults``: exact counts of cohort slots whose client or action
  differs from the reference's draw (a select that never came counts
  its whole cohort), of warm-or-cold decisions unlike the reference's,
  of selects answered by no solve of the version they were asked at, of
  initial Q-network weights unlike the seed's, and of draws and TD
  updates more or fewer than the reference's.

The partition itself is not compared with the reference's: k-means++
seeding draws a point by where a uniform falls in the cumulative sum of
distances, and a rounding-sized change of the embedding moves that sum
past hundreds of rows, so two sound solves may seed, and settle,
differently.  ``partition_mismatch`` (the share of rows whose matched
cluster differs) is printed, not limited.

With ``control`` the reference's own float32 solve with TF32 products
takes the program's place, and its policy is followed in float32 with
TF32-rounded operands: the readings a lower precision gives.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from perfbench.reference import cohort as ref
from perfbench.reference.policy import TenantPolicy

EXACT = ("draw_faults", "drift_faults", "stale_faults", "init_faults",
         "step_faults")
#: leaves whose reference gradient is under this share of the median
#: leaf's move by round-off alone and are left out of ``change_gap``
STILL_LEAF = 1e-3
#: a row is off its nearest center past this much squared distance (the
#: embedding's rows have norm 1; f32 rounding is some 1e-7)
CENTER_TOL = 1e-6


@dataclasses.dataclass
class Solved:
    evals: np.ndarray
    embedding: np.ndarray
    assign: np.ndarray


def engine_spec(config: dict, seed: int) -> ref.EngineSpec:
    e, k, m = config["engine"], config["num_clusters"], config["num_landmarks"]
    return ref.EngineSpec(
        seed=seed, k=k, m=m, eigh_cutoff=e.get("eigh_cutoff", 2048),
        drift_threshold=e.get("drift_threshold", 0.05))


def spectrum_gap(got: Solved, want: Solved, k: int) -> float:
    return float(np.max(np.abs(np.asarray(got.evals, np.float64)[:k]
                               - np.asarray(want.evals, np.float64)[:k])))


def embedding_gap(got: Solved, want: Solved, device) -> float:
    import torch
    qa = torch.linalg.qr(torch.as_tensor(got.embedding, dtype=torch.float64,
                                         device=device))[0]
    qb = torch.linalg.qr(torch.as_tensor(want.embedding, dtype=torch.float64,
                                         device=device))[0]
    s = torch.linalg.svdvals(qa.T @ qb).min().item()
    return float(np.sqrt(max(0.0, 1.0 - min(s, 1.0) ** 2)))


def _centers(y: np.ndarray, assign: np.ndarray, k: int) -> np.ndarray:
    y = np.asarray(y, np.float64)
    counts = np.bincount(assign, minlength=k)[:k].astype(np.float64)
    sums = np.zeros((k, y.shape[1]))
    np.add.at(sums, assign, y)
    return sums / np.maximum(counts, 1.0)[:, None]


def match_labels(a: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    """perm with perm[j] = the label of ``a`` matched to label j of ``b``
    (most shared members)."""
    from scipy.optimize import linear_sum_assignment
    conf = np.zeros((k, k), np.int64)
    np.add.at(conf, (a, b), 1)
    rows, cols = linear_sum_assignment(-conf)
    perm = np.empty(k, np.int64)
    perm[cols] = rows
    return perm


def partition_mismatch(got: Solved, want: Solved, k: int) -> float:
    """Share of rows whose cluster, matched by members, differs."""
    a, b = np.asarray(got.assign), np.asarray(want.assign)
    perm = match_labels(a, b, k)
    inverse = np.empty(k, np.int64)
    inverse[perm] = np.arange(k)
    return float(np.mean(inverse[a] != b))


def assign_gap(got: Solved, want: Solved, k: int) -> float:
    """Share of rows off the nearest center: the program's clusters'
    centers and the distances in the reference's embedding, where a
    rotation of the program's changes no distance; a label outside
    [0, k) counts as off."""
    a = np.asarray(got.assign)
    bad = (a < 0) | (a >= k)
    a = np.clip(a, 0, k - 1)
    y = np.asarray(want.embedding, np.float64)
    c = _centers(y, a, k)
    d2 = ((y * y).sum(1)[:, None] + (c * c).sum(1)[None, :]
          - 2.0 * y @ c.T)
    own = d2[np.arange(len(a)), a]
    bad |= own > d2.min(1) + CENTER_TOL
    return float(bad.mean())


def compare_solve(got: Solved, want: Solved, k: int, device) -> dict:
    return {"spectrum_gap": spectrum_gap(got, want, k),
            "embedding_gap": embedding_gap(got, want, device),
            "assign_gap": assign_gap(got, want, k),
            "partition_mismatch": partition_mismatch(got, want, k)}


def _worst(acc: dict, new: dict) -> None:
    """Counts add up; gaps keep their worst."""
    for key, v in new.items():
        if key in EXACT:
            acc[key] = acc.get(key, 0) + v
        else:
            acc[key] = max(acc.get(key, 0.0), v)


def _solved(result) -> Solved:
    return Solved(result.evals, result.embedding, result.assign)


def check_solves(run, sampled, *, device, control: bool = False) -> tuple:
    """(program readings, control readings or None, solves compared)."""
    cfg = run.config
    k = cfg["num_clusters"]
    program: dict = {"drift_faults": 0}
    ctl: dict = {}
    compared = 0
    wanted = {id(p) for p in sampled}
    for tenant, pubs in sorted(run.publishes.items()):
        spec = engine_spec(cfg, run.tenants_seeds[tenant])
        log = run.logs[tenant]
        chain = ref.Chain(spec, cfg["num_clients"])
        marks = None
        seen: dict = {}               # fingerprint -> version, as scanned
        scanned = 0
        for pub in pubs:
            while pub.fp not in seen and scanned < log.versions:
                scanned += 1
                seen.setdefault(ref.fingerprint(log.table(scanned)), scanned)
            if pub.fp not in seen:
                raise AssertionError(
                    f"tenant {tenant}: the engine published a solve of a "
                    f"table the traffic never sent")
            v = pub.version = seen[pub.fp]
            table = log.table(v)
            cold, _ = chain.decide(table)
            if cold:
                chain.marks_table = table.copy()
                marks = None
            program["drift_faults"] += int(cold == pub.warm)
            if id(pub) not in wanted or pub.result is None:
                continue
            if marks is None:
                marks = ref.cold_landmarks(spec, chain.marks_table, device)
            want = ref.solve(spec, table, marks, cold=cold, device=device)
            want = Solved(want.evals, want.embedding, want.assign)
            got = compare_solve(_solved(pub.result), want, k, device)
            _worst(program, got)
            print(f"solve t{tenant} #{pub.seq} v{v} "
                  f"{'cold' if cold else 'warm'}: " + " ".join(
                      f"{n} {x:.3g}" for n, x in got.items()),
                  file=sys.stderr)
            if control:
                low = ref.solve(spec, table, marks, cold=cold, device=device,
                                dtype=torch.float32, tf32=True)
                _worst(ctl, compare_solve(
                    Solved(low.evals, low.embedding, low.assign), want, k,
                    device))
            compared += 1
            del want
    return program, (ctl if control else None), compared


def stale_faults(run) -> int:
    """Selects of the window answered by no solve of the version they
    were asked at."""
    bad = 0
    for rec in run.window_selects():
        if not rec.ok:
            continue
        pubs = run.publishes.get(rec.tenant, [])
        if (rec.answer is None or not 0 <= rec.answer < len(pubs)
                or pubs[rec.answer].version != rec.version):
            bad += 1
    return bad


def draw_faults(ids, actions, got_ids, got_actions) -> int:
    """Cohort slots whose client or action differs from the reference's,
    a slot missing on either side counting once for each."""
    bad = abs(len(ids) - len(got_ids)) + abs(len(actions) - len(got_actions))
    bad += sum(int(a != b) for a, b in zip(ids, got_ids))
    bad += sum(int(a != b) for a, b in zip(actions, got_actions))
    return bad


def change_gap(leaves: list, judge: TenantPolicy) -> float:
    """The worst leaf's gap between the norms of the change from the
    initial weights, ``leaves``' and the judge's, over the judge's norm
    of that leaf or of the median leaf, whichever is larger."""
    init = [p.double() for p in judge.initial_leaves()]
    if len(leaves) != len(init) or any(g.shape != i.shape
                                       for g, i in zip(leaves, init)):
        return float("inf")
    want = [float(torch.linalg.vector_norm(p.double() - i))
            for p, i in zip(judge.leaves(), init)]
    have = [float(torch.linalg.vector_norm(p.double() - i))
            for p, i in zip(leaves, init)]
    grads = np.sqrt(judge.grad_sq)
    keep = grads >= STILL_LEAF * np.median(grads)
    if not keep.any():
        return float("inf")
    floor = float(np.median(np.asarray(want)[keep]))
    return max(abs(h - w) / max(w, floor, 1e-30)
               for h, w, kept in zip(have, want, keep) if kept)


def check_policy(run, *, control: bool = False) -> tuple:
    """(program readings, control readings or None, state gap) of every
    tenant's policy, followed from its first round."""
    cfg = run.config
    k, size = cfg["num_clusters"], cfg["cohort_size"]
    program = {"draw_faults": 0, "q_gap": 0.0, "change_gap": 0.0,
               "init_faults": 0, "step_faults": 0}
    ctl = {"q_gap": 0.0, "change_gap": 0.0}
    state_gap = 0.0
    for tenant in sorted(run.initial_q):
        args = (run.tenants_seeds[tenant], k, cfg["target_accuracy"],
                cfg["dqn"])
        judge = TenantPolicy(*args)
        low = TenantPolicy(*args, dtype=torch.float32, tf32=True) \
            if control else None
        got0 = run.initial_q[tenant]
        if [p.shape for p in got0] != [p.shape for p in
                                       judge.initial_leaves()]:
            program["init_faults"] += sum(p.numel() for p in got0) or 1
        else:
            program["init_faults"] += sum(
                int((w != g).sum())
                for w, g in zip(judge.initial_leaves(), got0))
        log = run.logs[tenant]
        for rec in run.rounds_of(tenant):
            d = rec.draw
            if not rec.ok or d is None or len(d.q) != k:
                # a cohort that never came; the generator's draws can no
                # longer be followed past it
                program["draw_faults"] += size
                break
            table = log.table(rec.version)
            state, q, ids, actions = judge.draw(rec.assign, table, d.q, size)
            program["draw_faults"] += draw_faults(ids, actions, rec.ids,
                                                  d.actions)
            scale = max(float(np.max(np.abs(q))), 1e-30)
            program["q_gap"] = max(program["q_gap"], float(
                np.max(np.abs(np.asarray(d.q, np.float64) - q)) / scale))
            state_gap = max(state_gap, float(np.max(np.abs(
                np.asarray(d.state, np.float64) - state))))
            if low is not None:
                _, q_low, _, _ = low.draw(rec.assign, table, d.q, size)
                ctl["q_gap"] = max(ctl["q_gap"], float(np.max(np.abs(
                    q_low.astype(np.float64) - q)) / scale))
            if rec.accuracy is None:
                break
            judge.observe(rec.accuracy)
            if low is not None:
                low.observe(rec.accuracy)
        counts = run.policy_counts[tenant]
        program["step_faults"] += (abs(counts["steps"] - judge.steps)
                                   + abs(counts["train_calls"]
                                         - judge.train_calls))
        program["change_gap"] = max(program["change_gap"], change_gap(
            run.final_q[tenant], judge))
        if low is not None:
            ctl["change_gap"] = max(ctl["change_gap"], change_gap(
                low.leaves(), judge))
    return program, (ctl if control else None), state_gap


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the limited numbers."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        if value is None:
            continue
        rows.append((name, value, limit))
        if not value <= limit:
            ok = False
    return ok, rows
