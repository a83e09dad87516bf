"""tpuslam_torch's SGBM (kernels/sgbm.py) against tpuslam's.

Both are integer throughout, so the port's unspeckled disparity equals
tpuslam's bit for bit: on 96x320 pairs built as tests/test_sgbm.py builds
them, at three configurations (SGBMConfig(), the simple one of
test_sgbm.py, and min_d 0 with uniqueness and the left-right check on),
stage by stage (`_bt_cost`, `_box_sum_region`, `_aggregate`) and at a
width just above num_disparities + block_size.  Each place where the
translation could drift has a case: C-truncating division of negative
numerators, `>>` of negative int32, the first-minimum tie-break, the
int16 cost, the replicate-border box, the LR check's scatter-min into
the dump column and the region's write at minX1.  The speckled result
equals cv2.filterSpeckles of tpuslam's unspeckled map (newVal
(min_d-1)*16, window 1000, range 16*16): the port's filter runs to its
fixpoint, tpuslam's a fixed 16 rounds (ROADMAP C).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.config import SGBMConfig as JConfig
from tpuslam.kernels import sgbm as J
from tpuslam_torch.config import SGBMConfig
from tpuslam_torch.kernels import sgbm as T


CONFIGS = {
    "reference": dict(),
    "simple": dict(min_disparity=0, num_disparities=32, block_size=5,
                   p1=8, p2=32, disp12_max_diff=-1, uniqueness_ratio=0,
                   speckle_window_size=0),
    "min0_uniq_lr": dict(min_disparity=0, num_disparities=64,
                         uniqueness_ratio=10, disp12_max_diff=1),
}


def _pair(seed=0, h=96, w=320, shift=7):
    """tests/test_sgbm.py's pair: blurred noise shifted by `shift`."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w + 2 * shift + 8)).astype(np.uint8)
    base = cv2.GaussianBlur(base, (5, 5), 1.5)
    left = base[:, shift:shift + w].copy()
    right = base[:, 2 * shift:2 * shift + w].copy()
    return left, right


def _port(left, right, cfg, with_speckle=False):
    return T.sgbm(torch.from_numpy(left)[None], torch.from_numpy(right)[None],
                  SGBMConfig(**cfg), with_speckle=with_speckle,
                  device="cpu")[0].numpy()


def _ref(left, right, cfg):
    return np.asarray(J.sgbm(jnp.asarray(left), jnp.asarray(right),
                             JConfig(**cfg), with_speckle=False))


@pytest.fixture(scope="module")
def maps():
    """tpuslam's and the port's unspeckled maps of one pair (seed 3) at
    each configuration."""
    left, right = _pair(seed=3)
    return {k: (_ref(left, right, c), _port(left, right, c))
            for k, c in CONFIGS.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bit_equal_to_reference(maps, name):
    ref, got = maps[name]
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ref)
    invalid = (SGBMConfig(**CONFIGS[name]).min_disparity - 1) * 16
    assert (ref != invalid).mean() > 0.3          # real matches compared


def test_negative_disparities():
    """The pair swapped: its true disparity is -7, inside SGBMConfig()'s
    range from -64, so the disparities, the subpixel steps and the LR
    check's floor and ceil (`>>` of negative int32) go negative; equal to
    tpuslam's, and left of minX1 every pixel is invalid."""
    left, right = _pair(seed=3)
    ref = _ref(right, left, CONFIGS["reference"])
    got = _port(right, left, CONFIGS["reference"])
    np.testing.assert_array_equal(got, ref)
    invalid = (-64 - 1) * 16
    assert ((ref < 0) & (ref != invalid)).mean() > 0.3
    assert (got[:, :64] == invalid).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stages_bit_equal(name):
    """_bt_cost (int16), _box_sum_region and _aggregate each alone."""
    left, right = _pair(seed=1, h=24, w=200)
    jc, tc = JConfig(**CONFIGS[name]), SGBMConfig(**CONFIGS[name])
    c_ref = np.asarray(J._bt_cost(jnp.asarray(left), jnp.asarray(right), jc))
    c_got = T._bt_cost(torch.from_numpy(left)[None],
                       torch.from_numpy(right)[None], tc)[0]
    assert c_got.dtype == torch.int16
    np.testing.assert_array_equal(c_got.numpy(), c_ref)
    b_ref = np.asarray(J._box_sum_region(jnp.asarray(c_ref), jc.block_size))
    b_got = T._box_sum_region(torch.from_numpy(c_ref)[None], tc.block_size)
    np.testing.assert_array_equal(b_got[0].numpy(), b_ref)
    p1 = max(tc.p1, 1)
    p2 = max(tc.p2, p1 + 1)
    s_ref = np.asarray(J._aggregate(jnp.asarray(b_ref), p1, p2))
    s_got = T._aggregate(torch.from_numpy(b_ref)[None], p1, p2)
    np.testing.assert_array_equal(s_got[0].numpy(), s_ref)


def test_box_sum_replicates_borders():
    """A box wider than the grid: the replicate border counts the edge
    slab r times, as tpuslam's cumsum over its padded axis."""
    rng = np.random.default_rng(2)
    c = rng.integers(0, 93, (7, 5, 3)).astype(np.int16)
    ref = np.asarray(J._box_sum_region(jnp.asarray(c), 11))
    got = T._box_sum_region(torch.from_numpy(c)[None], 11)[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_trunc_div_truncates_toward_zero():
    a = torch.tensor([-7, -8, -1, 0, 1, 7, 8, -17], dtype=torch.int32)
    b = torch.tensor([2, 2, 4, 3, 4, 2, -3, 4], dtype=torch.int32)
    want = np.asarray(J._trunc_div(jnp.asarray(a.numpy()),
                                   jnp.asarray(b.numpy())))
    np.testing.assert_array_equal(T._trunc_div(a, b).numpy(), want)
    assert (want != (a // b).numpy()).any()      # floor division differs


def test_winner_takes_the_first_minimum():
    """Tied costs at several disparities: the winner is the first."""
    S = torch.tensor([[5, 3, 9, 3, 3, 7], [2, 2, 2, 2, 2, 2]],
                     dtype=torch.int32)
    minS, best = T._winner(S)
    assert minS.tolist() == [3, 2] and best.tolist() == [1, 0]


def test_flat_images_tie_everywhere():
    """Uniform images: every disparity costs the same at every pixel, so
    the map is the tie-break's throughout, equal to tpuslam's."""
    flat = np.full((16, 120), 90, np.uint8)
    cfg = dict(min_disparity=-8, num_disparities=32, block_size=5,
               uniqueness_ratio=0)
    got = _port(flat, flat, cfg)
    np.testing.assert_array_equal(got, _ref(flat, flat, cfg))
    assert (got[:, 24:112] == -8 * 16).all()


def test_narrow_width():
    """A width just above num_disparities + block_size (a valid region of
    a few columns), with and without negative min_d."""
    for cfg in (dict(min_disparity=0, num_disparities=16, block_size=5),
                dict(min_disparity=-8, num_disparities=16, block_size=5,
                     disp12_max_diff=0)):
        w = cfg["num_disparities"] + cfg["block_size"] + 1
        left, right = _pair(seed=4, h=20, w=w, shift=2)
        np.testing.assert_array_equal(_port(left, right, cfg),
                                      _ref(left, right, cfg))


def test_too_narrow_raises():
    left, right = _pair(seed=4, h=12, w=60)
    with pytest.raises(ValueError, match="no valid region"):
        _port(left, right, dict())


def test_groups_equal_one_batch(monkeypatch):
    """Frames run in groups; a batch in groups of one equals the batch in
    one group and each frame alone."""
    pairs = [_pair(seed=s, h=40, w=160) for s in (5, 6, 7)]
    lb = torch.from_numpy(np.stack([p[0] for p in pairs]))
    rb = torch.from_numpy(np.stack([p[1] for p in pairs]))
    cfg = SGBMConfig(**CONFIGS["min0_uniq_lr"])
    whole = T.sgbm(lb, rb, cfg, with_speckle=False, device="cpu")
    assert T.group_size(40, 160, cfg) >= 3
    monkeypatch.setattr(T, "GROUP_BYTES", 1)
    assert T.group_size(40, 160, cfg) == 1
    grouped = T.sgbm(lb, rb, cfg, with_speckle=False, device="cpu")
    torch.testing.assert_close(grouped, whole, rtol=0, atol=0)
    for i, (l, r) in enumerate(pairs):
        np.testing.assert_array_equal(whole[i].numpy(),
                                      _port(l, r, CONFIGS["min0_uniq_lr"]))


def _speckle_pair():
    """_pair(3) with a 30x30 block of other texture at disparity 20 inside
    its disparity-7 background: the block's occlusions and edges leave
    components of under 1000 pixels for the speckle pass to filter."""
    left, right = _pair(seed=3)
    rng = np.random.default_rng(9)
    patch = cv2.GaussianBlur(rng.integers(0, 255, (30, 30)).astype(np.uint8),
                             (5, 5), 1.5)
    left[30:60, 150:180] = patch
    right[30:60, 130:160] = patch
    return left, right


def test_speckled_equals_cv2_of_reference():
    """with_speckle: cv2.filterSpeckles of tpuslam's unspeckled map, with
    SGBM's x16 range; speckles were filtered."""
    left, right = _speckle_pair()
    cfg = SGBMConfig()
    ref_raw = _ref(left, right, CONFIGS["reference"])
    want = ref_raw.copy()
    cv2.filterSpeckles(want, (cfg.min_disparity - 1) * 16,
                       cfg.speckle_window_size, cfg.speckle_range * 16)
    got = _port(left, right, CONFIGS["reference"], with_speckle=True)
    np.testing.assert_array_equal(got, want)
    assert (got != ref_raw).sum() > 50
