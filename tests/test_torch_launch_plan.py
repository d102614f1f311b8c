"""Launch geometry of the batched kernel K6, on the CPU.

`ops/kernels/attention.py`: a call of S problems splits each problem's
keys into one problem's chunks, whatever S is, since the chunks set the
order of the combine's sums and each row must equal its call alone to the
bit; S decides only whether one CTA holds all of a tile's chunks and
merges them itself (the CTAs fold) or each CTA runs one chunk. The card
tests (`tests/test_torch_kernels.py`) show the bits.
"""

import pytest

from racing_slam_tpu_torch.ops.kernels import attention as k6

SHAPES = [  # Kq, Kk, H
    (2400, 2400, 4),  # LightGlue at 640x480
    (2400, 2333, 4),  # a ragged key count
    (280, 280, 4),  # the trainer's pairs
    (300, 900, 4),
    (100, 130, 4),  # fewer keys than a chunk of the default split
    (64, 64, 1),  # one tile, one chunk
]


def _tile_ranges(Kk: int, plan) -> list:
    """Each chunk's key tiles (those past the last key left out)."""
    tiles = -(-Kk // k6.KEY_TILE)
    return [range(min(c * plan.tiles_per_chunk, tiles), min((c + 1) * plan.tiles_per_chunk, tiles))
            for c in range(plan.chunks)]


@pytest.mark.parametrize("Kq,Kk,H", SHAPES)
def test_k6_chunk_boundaries_do_not_depend_on_S(Kq, Kk, H):
    one = k6.launch_plan(1, Kq, Kk, H)
    assert one.chunks == k6.default_chunks(Kq, Kk, H)
    for S in range(2, 9):
        plan = k6.launch_plan(S, Kq, Kk, H)
        assert (plan.chunks, plan.tiles_per_chunk) == (one.chunks, one.tiles_per_chunk)
        assert _tile_ranges(Kk, plan) == _tile_ranges(Kk, one)


@pytest.mark.parametrize("Kq,Kk,H", SHAPES)
@pytest.mark.parametrize("S", [1, 2, 3, 7, 8])
def test_k6_ctas_and_launches_follow_the_fold(Kq, Kk, H, S):
    """One CTA a (problem, query tile, head) when the CTAs fold, one a
    (problem, query tile, head, chunk) otherwise; a fold drops the combine
    launch."""
    plan = k6.launch_plan(S, Kq, Kk, H)
    assert plan.units == -(-Kq // k6.QUERY_TILE) * H
    assert plan.ctas == S * plan.units * (1 if plan.fold else plan.chunks)
    assert plan.launches == (2 if plan.fold else 3)
    assert plan.tiles_per_chunk * plan.chunks >= -(-Kk // k6.KEY_TILE)


@pytest.mark.parametrize("S,fold,ctas", [
    (1, False, 608),  # one chunk a CTA: the single call
    (2, False, 1216),
    (3, False, 1824),  # 456 folded CTAs would fill 69 % of one wave of 660
    (4, True, 608),  # 608 of 660: 92 %
    (5, False, 3040),  # 760 folded CTAs: 58 % of two waves
    (6, False, 3648),
    (7, True, 1064),  # 81 % of two waves
    (8, True, 1216),  # a lockstep frame of 8 rows: two launches
])
def test_k6_geometry_at_the_main_shape(S, fold, ctas):
    """[2400, 4, 32]: 38 query tiles, 4 heads, 4 chunks of 10 tiles (one
    problem's split aims at 4 x 132 CTAs); the card holds 5 x 132 CTAs.
    The fold follows the measured times at every S (PERF.md)."""
    plan = k6.launch_plan(S, 2400, 2400, 4)
    assert (plan.chunks, plan.tiles_per_chunk, plan.units) == (4, 10, 152)
    assert (plan.fold, plan.ctas) == (fold, ctas)


def test_k6_ctas_fold_where_they_fill_their_last_wave():
    """One CTA a (problem, query tile, head) where those fill at least
    FOLD_FILL of their last wave of the card's CTAs (or a problem has one
    chunk), one chunk a CTA otherwise: a batched call never launches more
    CTAs than S single calls."""
    slots = k6.CTAS_PER_SM * k6.SMS
    for Kq, Kk, H in SHAPES:
        one = k6.launch_plan(1, Kq, Kk, H)
        for S in range(1, 17):
            plan = k6.launch_plan(S, Kq, Kk, H)
            waves = -(-S * plan.units // slots)
            fill = S * plan.units / (waves * slots)
            assert plan.fold == (fill >= k6.FOLD_FILL or plan.chunks == 1), (Kq, Kk, S)
            assert plan.ctas == (S * plan.units if plan.fold else S * one.ctas)
            assert plan.ctas <= S * one.ctas


@pytest.mark.parametrize("chunks", [1, 2, 5, 37])
def test_k6_explicit_chunks(chunks):
    """A caller's split is taken as given, whatever S is; one chunk folds
    (no combine), since the merge of one chunk is the combine's."""
    tiles = -(-900 // k6.KEY_TILE)
    for S in (1, 2, 8):
        plan = k6.launch_plan(S, 300, 900, 4, chunks=chunks)
        assert (plan.chunks, plan.tiles_per_chunk) == (chunks, -(-tiles // chunks))
        if chunks == 1:
            assert plan.fold and plan.launches == 2
