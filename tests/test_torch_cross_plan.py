"""How the affinity CUDA kernel of B1 (quantized cross-affinity), B6 (RBF
cross-affinity), B7 (pairwise squared distances) and B8 (square RBF
affinity) splits its work: ``cross_tile_plan`` is a pure function of the
shapes, its grid covers every (row, column) entry exactly once and stays
within CUDA's limits, rows take vector stores exactly when m % 4 == 0,
and every wrapper hands the plan's rows a tile to its C entry.

``cross_tile_kernel`` in ``csrc/affinity_tile.cuh`` decodes ``blockIdx``
as :func:`entries` below does: row tile ``blockIdx.x``, column tile
``blockIdx.y``, 64 threads across the column tile with ``cols``
consecutive columns each, 4 row lanes.  These tests need no card.
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, _common, affinity

MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535
H100_SMS = 132
COL_THREADS, LANES = affinity._CROSS_COL_THREADS, affinity._CROSS_LANES


def entries(plan, n, m):
    """(visits of each row, visits of each column) over the whole grid.

    Rows and columns are decoded independently (a block's columns do not
    depend on its row tiles), so each (row, column) entry is written
    exactly once iff both counts are 1 everywhere.
    """
    row_visits = np.zeros(n, np.int64)
    for bx in range(plan.row_tiles):
        row0 = bx * plan.rows
        cnt = min(plan.rows, n - row0)
        for lane in range(LANES):
            row_visits[row0 + np.arange(lane, cnt, LANES)] += 1
    col_visits = np.zeros(m, np.int64)
    for by in range(plan.col_tiles):
        j0 = by * COL_THREADS * plan.cols + np.arange(COL_THREADS) * plan.cols
        for c in range(plan.cols):
            j = j0 + c
            np.add.at(col_visits, j[j < m], 1)
    return row_visits, col_visits


@pytest.mark.parametrize("n, m", list(itertools.product(
    [1, 37, 513, 100_000], [1, 21, 512, 640, 4096])))
@pytest.mark.parametrize("d", [8, 20])
def test_cross_tile_plan_covers_every_entry_once(n, m, d):
    plan = affinity.cross_tile_plan(n, m, d)
    assert plan == affinity.cross_tile_plan(n, m, d)            # pure
    assert plan.cols == (4 if d <= 8 else 2)
    row_visits, col_visits = entries(plan, n, m)
    assert np.all(row_visits == 1) and np.all(col_visits == 1)
    # no block without a row or a column
    assert (plan.row_tiles - 1) * plan.rows < n
    assert (plan.col_tiles - 1) * COL_THREADS * plan.cols < m


@pytest.mark.parametrize("n, m, d", [(1, 1, 1), (10 ** 9, 1, 8),
                                     (10 ** 6, 4096, 32),
                                     (2 ** 31 - 1, 16_000_000, 8)])
def test_cross_tile_plan_stays_within_cuda_grid_limits(n, m, d):
    plan = affinity.cross_tile_plan(n, m, d)
    assert 1 <= plan.row_tiles <= MAX_GRID_X
    assert 1 <= plan.col_tiles <= MAX_GRID_Y
    # rows a tile: what the kernel's shared memory holds, a multiple of
    # its row lanes (16-byte cp.async pieces of each tile)
    assert plan.rows in (4, 8, 16, 32, 64)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 21, 510, 512, 513, 640, 4096])
def test_cross_tile_plan_stores_scalars_exactly_when_m_is_not_a_multiple_of_4(
        m):
    assert affinity.cross_tile_plan(1000, m, 8).vec is (m % 4 == 0)
    assert affinity.cross_tile_plan(1000, m, 20).vec is (m % 4 == 0)


def test_cross_tile_plan_at_the_path_shapes():
    """B6 at the unfused Nyström path (10⁵ x 512): 64-row tiles in 2
    column tiles; B1's W at m = 512 in 4-row tiles, ~2 blocks an SM; at
    m = 4096, 64-row tiles in 16 column tiles."""
    assert affinity.cross_tile_plan(100_000, 512, 8) == affinity.CrossPlan(
        1563, 2, 64, 4, True)
    assert affinity.cross_tile_plan(512, 512, 8) == affinity.CrossPlan(
        128, 2, 4, 4, True)
    assert affinity.cross_tile_plan(4096, 4096, 8) == affinity.CrossPlan(
        64, 16, 64, 4, True)
    for n, m in ((100_000, 512), (512, 512), (4096, 4096)):
        plan = affinity.cross_tile_plan(n, m, 8)
        assert plan.row_tiles * plan.col_tiles >= 2 * H100_SMS - 8


# B7 (pairwise squared distances) and B8 (the square RBF affinity) run
# the same kernel on square outputs: the dense path's n = 2048, the fed
# loop's 100, and ragged n (a partial tile, scalar stores)
SQUARE = list(itertools.product([1, 5, 37, 100, 2048], [7, 8, 20]))


@pytest.mark.parametrize("n, d", SQUARE)
def test_cross_tile_plan_covers_every_entry_of_a_square_output_once(n, d):
    plan = affinity.cross_tile_plan(n, n, d)
    row_visits, col_visits = entries(plan, n, n)
    assert np.all(row_visits == 1) and np.all(col_visits == 1)
    assert 1 <= plan.row_tiles <= MAX_GRID_X
    assert 1 <= plan.col_tiles <= MAX_GRID_Y
    assert plan.rows in (4, 8, 16, 32, 64)
    assert plan.vec is (n % 4 == 0)


def test_cross_tile_plan_at_the_square_path_shapes():
    """B7 and B8 at the dense path's 2048² × 8: 8 column tiles of 64-row
    halved to 32-row tiles, 512 blocks; B7 at the fed loop's 100² × 8:
    25 blocks of 4 rows."""
    assert affinity.cross_tile_plan(2048, 2048, 8) == affinity.CrossPlan(
        64, 8, 32, 4, True)
    assert affinity.cross_tile_plan(100, 100, 8) == affinity.CrossPlan(
        25, 1, 4, 4, True)


class _Recorder:
    """Stands in for the built kernels: records each C entry's arguments
    and checks their count against the entry's ctypes signature."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, entry):
        argtypes = _build._SIGNATURES["affinity.cu"][entry]

        def fn(*args):
            assert len(args) == len(argtypes)
            self.calls[entry] = args
            return 0
        return fn


@pytest.fixture
def recorded_launch(monkeypatch):
    """Drives a wrapper past its CPU route without a card: the inputs
    are CPU tensors reported as lying on a device, the output is a meta
    tensor, and the library is a ``_Recorder``.  Restores the launch
    counts afterwards."""
    lib = _Recorder()
    monkeypatch.setattr(affinity, "check_tensors",
                        lambda name, **t: torch.device("meta"))
    monkeypatch.setattr(affinity._build, "library", lambda: lib)
    monkeypatch.setattr(affinity, "stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    counts = dict(_common.LAUNCH_COUNTS)
    yield lib
    _common.LAUNCH_COUNTS.update(counts)


@pytest.mark.parametrize("n, d", SQUARE)
def test_square_entries_get_the_plans_rows(recorded_launch, n, d):
    """rt_pairwise_sq_dists and rt_rbf_affinity take the rows a tile of
    ``cross_tile_plan`` (m = n for B8), as rt_rbf_cross_affinity does."""
    x = torch.zeros((n, d))
    rows = affinity.cross_tile_plan(n, n, d).rows
    out = affinity.pairwise_sq_dists(x, x)
    assert tuple(out.shape) == (n, n)
    assert recorded_launch.calls["rt_pairwise_sq_dists"][3:7] == (n, n, d,
                                                                  rows)
    affinity.rbf_affinity(x, 0.5)
    assert recorded_launch.calls["rt_rbf_affinity"][3:6] == (n, d, rows)
    affinity.rbf_cross_affinity(x, x, 0.5)
    assert recorded_launch.calls["rt_rbf_cross_affinity"][4:8] == (n, n, d,
                                                                   rows)
