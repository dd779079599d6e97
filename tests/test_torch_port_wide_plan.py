"""The grids of K2-K4's wide path (M or D above NARROW_WIDTH), as
``split_plan`` and ``loop_splits`` lay them out, on the CPU: the blocks of
one split cover every tile of output rows (K4's 32 keys, 64 rows
otherwise) and every output feature once, and the S splits cut the loop
axis into contiguous chunks of whole tiles, none of them empty. The card
runs the grid that these numbers describe (``csrc/sigmoid_attention.cu``
reads the same chunk and split count); test_torch_port_cuda.py holds the
kernels against their plain versions on it.
"""

import pytest

from difformer_tpu_torch.kernels import sigmoid_attention as K
import torch_port_helpers  # noqa: F401  (sets torch's threads)

H100_SMS = 132
FWD, DQ, DKV = ("sigmoid_attention_fwd", "sigmoid_attention_dq",
                "sigmoid_attention_dkv")
# (N, L, H, M, D): the cifar10 preset's attention (15000 rows, hidden 300),
# stl10's width, ragged N and L, M apart from D, and two heads
SHAPES = [
    (15000, 15000, 1, 300, 300),
    (15000, 15000, 1, 400, 400),
    (15001, 14999, 1, 300, 300),
    (301, 97, 1, 257, 300),
    (97, 301, 2, 300, 257),
    (130, 140, 2, 512, 600),
    (100, 120, 1, 64, 400),
]


def _cdiv(a, b):
    return -(-a // b)


def _grid(name, n, l, h, m, d):
    """Every block of the wide grid as (row tile, head, feature range,
    loop tile range), from the split plan, and the plan itself."""
    per_split, splits, chunk = K.split_plan(name, n, l, h, m, d, H100_SMS)
    own, loop = (l, n) if name == DKV else (n, l)
    tile = K.WIDE_OWN_TILE[name]
    cols = K.WIDE_COLUMNS[name]
    # the features a block holds: its group's share of the output (K4: of
    # dk and of dv side by side, so its widest)
    width = {FWD: d, DQ: m, DKV: max(m, d)}[name]
    groups = _cdiv(width, cols)
    loop_tiles = _cdiv(loop, K.TILE)
    blocks = []
    for s in range(splits):
        span = range(s * chunk, min((s + 1) * chunk, loop_tiles))
        for x in range(_cdiv(own, tile)):
            for head in range(h):
                for z in range(groups):
                    blocks.append((x, head, range(z * cols,
                                                  min((z + 1) * cols, width)),
                                   span))
    return blocks, (per_split, splits, chunk), (own, tile, width, loop_tiles)


@pytest.mark.parametrize("name", [FWD, DQ, DKV])
@pytest.mark.parametrize("shape", SHAPES)
def test_wide_blocks_cover_rows_features_and_loop_once(name, shape):
    n, l, h, m, d = shape
    assert K.is_wide(m, d)
    blocks, (per_split, splits, chunk), (own, tile, width, loop_tiles) = \
        _grid(name, n, l, h, m, d)
    assert len(blocks) == per_split * splits
    # no split is empty, and together they take every loop tile once
    spans = sorted({(b[3].start, b[3].stop) for b in blocks})
    assert len(spans) == splits
    assert all(stop > start for start, stop in spans)
    assert spans[0][0] == 0 and spans[-1][1] == loop_tiles
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # within a split, every (row tile, head, feature) is owned once
    for start, _ in spans:
        seen = {}
        for x, head, feats, span in blocks:
            if span.start != start:
                continue
            for f in feats:
                key = (x, head, f)
                assert key not in seen
                seen[key] = True
        assert len(seen) == _cdiv(own, tile) * h * width


@pytest.mark.parametrize("name,plan", [
    # K2: 235 row tiles of 64 split 5 ways, 8.9 waves of 132 SMs
    (FWD, (235, 5, 47)),
    # K3: on the tensor cores since its redesign, K2's grid: 235 row tiles
    # of 64 (448 features of dq a block) split 5 ways, 8.9 waves
    (DQ, (235, 5, 47)),
    # K4: 469 tiles of 32 keys (dk and dv in one block) split 5 ways
    (DKV, (469, 5, 47)),
])
def test_wide_plan_at_the_cifar10_shape(name, plan):
    """The grids that the cifar10 preset's sigmoid run launches at
    N = L = 15000, hidden 300, on an H100's 132 SMs."""
    assert K.split_plan(name, 15000, 15000, 1, 300, 300, H100_SMS) == plan


@pytest.mark.parametrize("own,loop,per_tile,per_sm,own_tile", [
    (15000, 15000, 1, 8, 64),
    (15000, 15000, 1, 15, 32),
    (15001, 301, 1, 15, 32),
    (64, 5000, 2, 8, 64),
    (5000, 64, 1, 15, 32),
])
def test_loop_splits_leave_no_split_empty(own, loop, per_tile, per_sm,
                                          own_tile):
    splits, chunk = K.loop_splits(own, loop, per_tile, H100_SMS, per_sm,
                                  own_tile)
    tiles = _cdiv(loop, K.TILE)
    assert splits * chunk >= tiles > (splits - 1) * chunk
    own_blocks = _cdiv(own, own_tile) * per_tile
    target = per_sm * H100_SMS
    if own_blocks >= target:
        assert splits == 1
    else:  # S grows toward the target, never past one split a loop tile
        assert 1 <= splits <= min(tiles, _cdiv(target, own_blocks))


def test_wide_k4_takes_dk_and_dv_in_one_group_at_the_set_widths():
    """Up to WIDE_COLUMNS features of dk and of dv, one block takes both
    from one pass over s; wider problems add z groups."""
    for width in (300, 400, 448):
        per_split, _, _ = K.split_plan(DKV, 15000, 15000, 1, width, width,
                                       H100_SMS)
        assert per_split == _cdiv(15000, K.WIDE_OWN_TILE[DKV])
    per_split, _, _ = K.split_plan(DKV, 15000, 15000, 1, 512, 600, H100_SMS)
    assert per_split == 2 * _cdiv(15000, K.WIDE_OWN_TILE[DKV])
