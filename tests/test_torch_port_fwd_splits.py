"""The key split of the flash sigmoid attention forward kernel (K2).

K2 launches one block per (query tile, head, split), and each split takes
a contiguous chunk of whole key tiles. The rule that picks the number of
splits is plain Python (``fwd_key_splits``), checked here at the shapes the
port runs: Cora's and pubmed's sizes, a ragged two-head case, few queries
over many keys, and a single key.
"""

import pytest

from difformer_tpu_torch.kernels import sigmoid_attention as K

H100_SMS = 132


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("n,l,h,sms", [
    (2708, 2708, 1, H100_SMS),    # Cora
    (19717, 19717, 1, H100_SMS),  # pubmed
    (1000, 1300, 2, H100_SMS),    # ragged, two heads
    (64, 5000, 1, H100_SMS),      # one query tile, many key tiles
    (300, 1, 1, H100_SMS),        # a single key
    (2708, 2708, 1, 114),         # Cora on a card of fewer SMs
])
def test_fwd_key_splits(n, l, h, sms):
    splits, chunk = K.fwd_key_splits(n, l, h, sms)
    tiles = _cdiv(l, K.FWD_TILE)
    q_blocks = _cdiv(n, K.FWD_TILE) * h
    assert splits >= 1 and chunk >= 1
    # the chunks cover every key tile exactly once, and none is empty
    owned = [t for s in range(splits)
             for t in range(s * chunk, min((s + 1) * chunk, tiles))]
    assert owned == list(range(tiles))
    assert (splits - 1) * chunk < tiles
    target = K.FWD_BLOCKS_PER_SM * sms
    if q_blocks >= target:
        assert (splits, chunk) == (1, tiles)
    else:
        # more blocks than the query tiles alone, up to the target
        assert splits > 1 or tiles == 1
        assert q_blocks * (splits - 1) < target
    if (n, l, h) == (2708, 2708, 1):
        assert q_blocks * splits >= sms  # the grid reaches every SM
