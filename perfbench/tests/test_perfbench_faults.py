"""The comparison catches the faults a cohort cell can have.

Each test drives the rest of a run on the CPU at a small size (the
harness's look for a card skipped, the kernels' plain versions in the
CUDA ones' place), with the timed path broken underneath, and sees
``correct`` come out false; the unbroken run comes out true.  A cell on
one card has no exchange between cards to leave out.
"""

import time

import numpy as np

from perfbench.harness import cli
from perfbench.tests.tiny import tiny_cell


def _run(cell, seed=2 ** 31 + 11, seconds=4.0):
    return cli.execute("tiny", seed, seconds, trace=False, control=False,
                       device="cpu", process_start=time.perf_counter(),
                       cell=cell)


def test_a_sound_run_is_correct():
    res = _run(tiny_cell())
    assert res["correct"], res["checks"]
    assert res["info"]["solves_compared"] >= 2
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["info"]["state_gap"] < 1e-5


def test_a_solve_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    """The engine answers every select after set-up with the result it
    already holds, and solves nothing new."""
    from repro_torch.cohort.engine import CohortEngine
    select = CohortEngine.select

    def stale(self, embeds, *, key=None):
        if self.state.result is not None and self.stats["solves"] >= 3:
            return self.state.result
        return select(self, embeds, key=key)

    monkeypatch.setattr(CohortEngine, "select", stale)
    res = _run(tiny_cell())
    assert not res["correct"]
    assert res["checks"]["stale_faults"]["value"] > 0


def test_half_the_rows_left_out_of_the_gram_is_caught(monkeypatch):
    """B3 sums S^T S over half of the rows and scales by two (the mean
    over the rest)."""
    from repro_torch.kernels import ops
    gram = ops.nystrom_gram

    def half(x, z, gamma, u, w_isqrt, mask=None, **kw):
        h = x.shape[0] // 2
        m = None if mask is None else mask[:h]
        return 2.0 * gram(x[:h].contiguous(), z, gamma, u, w_isqrt, m, **kw)

    monkeypatch.setattr(ops, "nystrom_gram", half)
    res = _run(tiny_cell())
    assert not res["correct"]


def test_half_the_rows_left_out_of_the_colsum_is_caught(monkeypatch):
    from repro_torch.kernels import ops
    colsum = ops.nystrom_colsum

    def half(x, z, gamma, mask=None, **kw):
        h = x.shape[0] // 2
        return 2.0 * colsum(x[:h].contiguous(), z, gamma,
                            None if mask is None else mask[:h], **kw)

    monkeypatch.setattr(ops, "nystrom_colsum", half)
    res = _run(tiny_cell())
    assert not res["correct"]


def test_a_cohort_id_altered_where_drawn_is_caught(monkeypatch):
    """The draw hands back one client of another cluster in place of
    the one its slot's action chose."""
    from repro_torch.policy.cluster_policy import ClusterPolicy
    draw = ClusterPolicy.draw

    def altered(self, rng, state_vec, pools, cohort_size):
        picked, actions = draw(self, rng, state_vec, pools, cohort_size)
        other = next(c for c in pools if c != actions[0] and pools[c])
        picked[0] = pools[other][0]
        return picked, actions

    monkeypatch.setattr(ClusterPolicy, "draw", altered)
    res = _run(tiny_cell())
    assert not res["correct"]
    assert res["checks"]["draw_faults"]["value"] > 0


def test_a_cluster_label_altered_where_assigned_is_caught(monkeypatch):
    """k-means hands back a tenth of its rows under another label."""
    from repro_torch.cohort import engine
    kmeans = engine.kmeans

    def altered(gen, y, k, iters=25):
        assign, centers = kmeans(gen, y, k, iters)
        assign = assign.clone()
        assign[::10] = (assign[::10] + 1) % k
        return assign, centers

    monkeypatch.setattr(engine, "kmeans", altered)
    res = _run(tiny_cell())
    assert not res["correct"]
    gap = res["checks"]["assign_gap"]
    assert gap["value"] > gap["limit"]


def test_an_action_value_altered_where_computed_is_caught(monkeypatch):
    from repro_torch.core.dqn import DQNAgent
    q_values = DQNAgent.q_values

    def altered(self, state):
        q = q_values(self, state)
        return q + np.float32(1e-3) * np.abs(q).max()

    monkeypatch.setattr(DQNAgent, "q_values", altered)
    res = _run(tiny_cell())
    assert not res["correct"]
    assert res["checks"]["q_gap"]["value"] > res["checks"]["q_gap"]["limit"]


def test_an_eigenvalue_altered_where_solved_is_caught(monkeypatch):
    """The landmark operator's eigenvalues come back low by twice the
    spectrum's limit."""
    from repro_torch.cohort import nystrom, sharded
    solve = nystrom._solve_operator
    cell = tiny_cell()
    shift = 2.0 * cell["config"]["limits"]["spectrum_gap"]

    def altered(*args, **kw):
        lam, basis = solve(*args, **kw)
        return lam - shift, basis

    for module in (nystrom, sharded):     # the mesh route imports it
        monkeypatch.setattr(module, "_solve_operator", altered)
    res = _run(cell)
    assert not res["correct"]


def test_a_td_step_that_leaves_the_network_unchanged_is_caught(
        monkeypatch):
    """The policy's update counts itself and returns, the weights as
    they were."""
    from repro_torch.core.dqn import DQNAgent

    def still(self, rng):
        if self.buffer.size < 8:
            return 0.0
        self.buffer.sample(rng, self.cfg.batch_size)
        self.train_calls += 1
        return 0.0

    monkeypatch.setattr(DQNAgent, "train_step", still)
    res = _run(tiny_cell())
    assert not res["correct"]
    gap = res["checks"]["change_gap"]
    assert gap["value"] > gap["limit"]


def test_half_the_minibatch_left_out_of_the_td_loss_is_caught(monkeypatch):
    """The TD loss is the mean over the first half of the minibatch."""
    from repro_torch.core import dqn
    td_loss = dqn.td_loss

    def half(net, target, batch, gamma, double_dqn):
        h = len(batch["a"]) // 2
        return td_loss(net, target, {key: v[:h] for key, v in batch.items()},
                       gamma, double_dqn)

    monkeypatch.setattr(dqn, "td_loss", half)
    res = _run(tiny_cell())
    assert not res["correct"]


def test_a_greedy_slot_off_the_best_action_is_caught(monkeypatch):
    """The draw orders the clusters by rising action value, so its
    greedy slots take the worst cluster."""
    from repro_torch.policy.cluster_policy import ClusterPolicy
    draw = ClusterPolicy.draw

    def worst_first(self, rng, state_vec, pools, cohort_size):
        q_values = self.agent.q_values
        self.agent.q_values = lambda s: -q_values(s)
        try:
            return draw(self, rng, state_vec, pools, cohort_size)
        finally:
            self.agent.q_values = q_values

    monkeypatch.setattr(ClusterPolicy, "draw", worst_first)
    res = _run(tiny_cell())
    assert not res["correct"]
    assert res["checks"]["draw_faults"]["value"] > 0
