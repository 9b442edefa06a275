"""How the B2 (Nyström colsum), B3 (Nyström Gram) and B10 (SSD chunk) CUDA
kernels split their work into blocks: pure functions of the shapes, that
cover the work exactly once and stay within CUDA's grid limits; and the
width of B4's (Nyström extension) packed landmark rows, which its wrapper
allocates.

The kernels decode ``blockIdx`` the same way (``gram_pair`` in
``csrc/nystrom.cu``, ``ssd_chunk_kernel`` in ``csrc/ssd.cu``); these tests
need no card.
"""

import itertools
import math

import pytest

from repro_torch.kernels import nystrom as kn
from repro_torch.kernels import ssd

MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535
H100_SMS = 132


@pytest.mark.parametrize("m", [1, 65, 127, 128, 129, 512, 640, 2048, 4096,
                               8192])
def test_gram_tile_pairs_cover_the_upper_triangle_once(m):
    tiles = math.ceil(m / 128)
    pairs = kn.gram_tile_pairs(m)
    assert pairs == kn.gram_tile_pairs(m)                   # pure
    assert len(pairs) == len(set(pairs)) == tiles * (tiles + 1) // 2
    assert set(pairs) == {(p, q) for p in range(tiles)
                          for q in range(p, tiles)}
    assert len(pairs) <= MAX_GRID_X
    # block i is pair i, in row order, as the kernel decodes it
    assert pairs == [kn.gram_pair(tiles, i) for i in range(len(pairs))]
    assert pairs == sorted(pairs)


@pytest.mark.parametrize("n, m", list(itertools.product(
    [1, 31, 261, 3001, 100_000, 1_000_000], [1, 65, 512, 640, 4096])))
def test_gram_slabs_split_every_row_once(n, m):
    slabs, rows = kn.gram_slabs(n, m)
    assert (slabs, rows) == kn.gram_slabs(n, m)             # pure
    assert rows % 32 == 0 and rows >= 32
    assert 1 <= slabs <= MAX_GRID_Y
    # the slabs tile [0, n): none is empty, none is left out
    assert (slabs - 1) * rows < n <= slabs * rows
    pairs = len(kn.gram_tile_pairs(m))
    scratch = slabs * pairs * 128 * 128
    assert slabs == 1 or scratch <= kn._GRAM_SCRATCH_CAP


def test_gram_slabs_fill_the_card_at_the_path_shapes():
    """At least 2 blocks an SM of a 132-SM H100 at the server's m = 512
    and the engine's m = 4096; the m = 4096 scratch stays under its
    cap."""
    for m in (512, 4096):
        slabs, _ = kn.gram_slabs(100_000, m)
        assert slabs * len(kn.gram_tile_pairs(m)) >= 2 * H100_SMS
    slabs, _ = kn.gram_slabs(100_000, 4096)
    assert slabs * 528 * 128 * 128 * 4 <= 128 * 2 ** 20


def test_colsum_grid_at_the_path_shape():
    """B2: a block owns one 256-row panel (the reduction tree B2 must keep)
    and 4 landmarks a thread x 128 columns at d <= 8; at N = 10⁵ and
    m = 512 or 4096 at least 2 blocks on each of an H100's 132 SMs."""
    assert kn.colsum_grid(100_000, 512, 8) == (391, 1, 4)
    assert kn.colsum_grid(3001, 640, 20) == (12, 3, 2)
    for m in (512, 4096):
        panels, tiles, _ = kn.colsum_grid(100_000, m, 8)
        assert panels * tiles >= 2 * H100_SMS and tiles <= MAX_GRID_Y


def test_extension_packed_rows_are_16_byte_aligned():
    """A packed landmark row of B4: coordinates, |z|², scale, u, 0, then
    proj padded to 4, read by float4 broadcasts and 16-byte cp.async
    pieces."""
    assert [kn.extension_row_width(d, k) for d, k in
            [(8, 8), (7, 5), (8, 20), (9, 1), (32, 64)]] == [20, 20, 32, 40,
                                                              100]


SSD_SHAPES = [
    # (B, c, Q, H, G, N)
    (1, 8, 256, 80, 1, 128),     # mamba2-2.7b's prefill
    (1, 8, 256, 128, 1, 16),     # jamba-v0.1's Mamba layer
    (1, 2, 256, 80, 1, 128),
    (1, 1, 256, 6, 1, 128),      # a partial last head set
    (1, 2, 256, 8, 2, 128),      # two groups
    (2, 3, 8, 4, 2, 16),         # the reduced shapes
    (1, 2, 19, 2, 1, 16),
    (3, 5, 100, 12, 3, 16),      # R = 4 heads a group, two row tiles
]


@pytest.mark.parametrize("B, c, Q, H, G, N", SSD_SHAPES)
def test_ssd_blocks_cover_every_cell_once(B, c, Q, H, G, N):
    plan = ssd.ssd_plan(B, c, Q, H, G, N)
    assert plan == ssd.ssd_plan(B, c, Q, H, G, N)           # pure
    blocks = list(ssd.ssd_blocks(B, c, Q, H, G, N))
    assert blocks == list(ssd.ssd_blocks(B, c, Q, H, G, N))
    assert len(blocks) == plan["blocks"] <= MAX_GRID_X
    R = H // G
    seen = {}
    for kind, first, b, chunk, heads in blocks:
        assert 1 <= len(heads) <= plan["head_set"]
        # a head set never spans two groups
        assert len({h // R for h in heads}) == 1
        for h in heads:
            key = (kind, first, b, chunk, h)
            assert key not in seen
            seen[key] = True
    starts = {"state": range(0, N, plan["state_cols"]),
              "rows": range(0, Q, 64)}
    want = {(kind, first, b, chunk, h) for kind, firsts in starts.items()
            for first in firsts for b in range(B) for chunk in range(c)
            for h in range(H)}
    assert set(seen) == want


@pytest.mark.parametrize("B, c, Q, H, G, N", SSD_SHAPES)
def test_ssd_blocks_come_heaviest_first(B, c, Q, H, G, N):
    """The state slices (every row of the chunk), then the row tiles from
    the last: a block's rows to walk never grow along the grid."""
    def work(kind, first):
        return Q if kind == "state" else min(first + 64, Q)

    loads = [work(kind, first) for kind, first, *_ in
             ssd.ssd_blocks(B, c, Q, H, G, N)]
    assert loads == sorted(loads, reverse=True)


def test_ssd_plan_at_jambas_state_width():
    """N = 16 < kStateCols: one state block owns all 16 columns."""
    plan = ssd.ssd_plan(1, 8, 256, 128, 1, 16)
    assert plan["state_cols"] == 16 and plan["state_blocks"] == 1
    assert plan["sets"] == 32 and plan["roles"] == 5
    assert (64, 16) in ssd.SHAPES


def test_ssd_plan_fills_the_card_at_the_mamba2_prefill():
    """At least 2 waves of 2 blocks on each of an H100's 132 SMs."""
    plan = ssd.ssd_plan(1, 8, 256, 80, 1, 128)
    assert plan["sets"] == 20 and plan["roles"] == 6
    assert plan["blocks"] >= 2 * 2 * H100_SMS
