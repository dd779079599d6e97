"""The split of the loop axis of the flash sigmoid attention kernels.

K2 (forward) and K3 (dq) own query tiles and loop over key tiles; K4 (dk/dv)
owns key tiles and loops over query tiles. Each launches one block per (own
tile, head, feature group, split), and each split takes a contiguous chunk of
whole loop tiles. The one rule that picks the number of splits is plain
Python (``loop_splits``, through ``split_plan``), checked here for all three
kernels at the shapes the port runs: Cora's and pubmed's sizes, a ragged
two-head case, few queries over many keys and the transpose, a single key,
and widths of two and four feature groups.
"""

import pytest

from difformer_tpu_torch.kernels import sigmoid_attention as K
import torch_port_helpers  # noqa: F401  (sets torch's threads)

H100_SMS = 132
FWD, DQ, DKV = ("sigmoid_attention_fwd", "sigmoid_attention_dq",
                "sigmoid_attention_dkv")

CASES = [
    (2708, 2708, 1, H100_SMS),    # Cora
    (19717, 19717, 1, H100_SMS),  # pubmed
    (1000, 1300, 2, H100_SMS),    # ragged, two heads
    (64, 5000, 1, H100_SMS),      # one query tile, many key tiles
    (300, 1, 1, H100_SMS),        # a single key
    (2708, 2708, 1, 114),         # Cora on a card of fewer SMs
    (5000, 64, 1, H100_SMS),      # many query tiles, one key tile
]


def _cdiv(a, b):
    return -(-a // b)


def _check(name, n, l, h, sms, m=64, d=64):
    per_split, splits, chunk = K.split_plan(name, n, l, h, m, d, sms)
    own, loop = (l, n) if name == DKV else (n, l)
    tiles = _cdiv(loop, K.TILE)
    assert splits >= 1 and chunk >= 1
    assert per_split % (_cdiv(own, K.TILE) * h) == 0  # whole feature groups
    # the chunks cover every loop tile exactly once, and none is empty
    owned = [t for s in range(splits)
             for t in range(s * chunk, min((s + 1) * chunk, tiles))]
    assert owned == list(range(tiles))
    assert (splits - 1) * chunk < tiles
    per_sm = {FWD: K.FWD_BLOCKS_PER_SM, DQ: K.DQ_BLOCKS_PER_SM,
              DKV: K.DKV_BLOCKS_PER_SM}[name]
    target = per_sm * sms
    if per_split >= target:
        assert (splits, chunk) == (1, tiles)
    else:
        # more blocks than the own tiles alone, up to the target
        assert splits > 1 or tiles == 1
        assert per_split * (splits - 1) < target
    if (n, l, h) == (2708, 2708, 1):
        assert per_split * splits >= sms  # the grid reaches every SM
    return per_split, splits


@pytest.mark.parametrize("n,l,h,sms", CASES)
def test_fwd_key_splits(n, l, h, sms):
    per_split, _ = _check(FWD, n, l, h, sms)
    assert per_split == _cdiv(n, K.TILE) * h  # K2 holds every width itself


@pytest.mark.parametrize("name", [DQ, DKV])
@pytest.mark.parametrize("n,l,h,sms", CASES)
def test_bwd_splits(name, n, l, h, sms):
    _check(name, n, l, h, sms)


@pytest.mark.parametrize("m,d,groups", [(64, 64, 1), (32, 48, 1),
                                        (100, 120, 2), (256, 200, 4)])
def test_dkv_blocks_per_feature_group(m, d, groups):
    """K4 gives each group of 64 output features of dk and dv its own
    blocks; K2 keeps every width in one block."""
    per_split, _ = _check(DKV, 2708, 2708, 2, H100_SMS, m=m, d=d)
    assert per_split == 43 * 2 * groups
    assert K.split_plan(FWD, 2708, 2708, 2, m, d, H100_SMS)[0] == 43 * 2


def test_dkv_splits_its_queries():
    """One key tile over 79 query tiles: K4 gives each query tile a block."""
    assert K.split_plan(DKV, 5000, 64, 1, 64, 64, H100_SMS) == (1, 79, 1)
    # pubmed's 309 key tiles fill two blocks on each of 132 SMs alone
    assert K.split_plan(DKV, 19717, 19717, 1, 64, 64, H100_SMS)[1] == 1
