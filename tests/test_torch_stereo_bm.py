"""tpuslam_torch StereoBM against tpuslam's.

The plain PyTorch StereoBM (the CPU path of the dispatcher, and the
reference kernel K1 is checked against on the card) must be BIT-EQUAL to
tpuslam.kernels.stereo_bm.stereo_bm, the XLA twin that
tests/test_bm_pallas.py pins bit-equal to the Pallas strip kernel.  The
arithmetic is integer throughout, so no tolerance applies.
"""

import numpy as np
import pytest
import torch

from tpuslam.config import StereoBMConfig as JCfg
from tpuslam.kernels import stereo_bm as J

from tpuslam_torch.config import StereoBMConfig
from tpuslam_torch.kernels import stereo_bm as T

# the suite runs several worker processes on the machine's cores: more
# intra-op threads per worker oversubscribe them and spin-wait
torch.set_num_threads(1)

SLICE = dict(disp12_max_diff=-1)     # the slice: no left-right check


def _pair(stereo_pair, rows=None):
    left, right = stereo_pair
    if rows is not None:
        left, right = left[:rows], right[:rows]
    return np.ascontiguousarray(left), np.ascontiguousarray(right)


def _ref(left, right, **kw):
    return np.asarray(J.stereo_bm(left, right, JCfg(**SLICE, **kw),
                                  with_speckle=False))


def _port(left, right, **kw):
    disp, minsad = T.stereo_bm_plain(torch.as_tensor(left)[None],
                                     torch.as_tensor(right)[None],
                                     StereoBMConfig(**SLICE, **kw))
    return disp[0].numpy(), minsad[0].numpy()


def test_prefilter_matches(stereo_pair):
    left, _ = stereo_pair
    ref = np.asarray(J.prefilter_xsobel(left, 31))
    got = T.prefilter_xsobel(torch.as_tensor(left)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_box_sum_matches(rng):
    x = rng.integers(0, 63, (2, 37, 53)).astype(np.int32)
    ref = np.asarray(J._box_sum(x, 10))
    got = T._box_sum(torch.as_tensor(x), 10).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rows", [None, 376])
def test_disparity_bit_equal(stereo_pair, rows):
    """The 640x480 fixture and its 376-row crop (the bench's height)."""
    left, right = _pair(stereo_pair, rows)
    ref = _ref(left, right)
    disp, minsad = _port(left, right)
    assert disp.dtype == ref.dtype == np.int16
    np.testing.assert_array_equal(disp, ref)
    assert (ref > 0).mean() > 0.2          # the fixture really matches
    # minsad is bounded by 62 * 21^2 and int16
    assert minsad.min() >= 0 and minsad.max() <= 62 * 441


def test_disparity_bit_equal_small_config(rng):
    """Another window and disparity count, on a synthetic shifted pair."""
    left = rng.integers(0, 256, (53, 197), dtype=np.uint8)
    right = np.roll(left, -5, axis=1)
    kw = dict(num_disparities=16, block_size=9, uniqueness_ratio=0)
    np.testing.assert_array_equal(_port(left, right, **kw)[0],
                                  _ref(left, right, **kw))


def test_batch_dispatch_uses_plain_on_cpu(stereo_pair):
    from tpuslam_torch.kernels import _cuda
    left, right = _pair(stereo_pair, 96)
    lb = torch.as_tensor(np.stack([left, left[::-1].copy()]))
    rb = torch.as_tensor(np.stack([right, right[::-1].copy()]))
    _cuda.reset_counters()
    disp = T.stereo_bm(lb, rb, StereoBMConfig(**SLICE))
    assert _cuda.PLAIN_CALLS["stereo_bm"] == 1
    assert _cuda.LAUNCHES["stereo_bm"] == 0
    np.testing.assert_array_equal(disp[1].numpy(),
                                  _ref(left[::-1].copy(),
                                       right[::-1].copy()))


def test_lr_check_raises(stereo_pair):
    """The K5 wrapper checks its arguments before any build or launch: a
    CPU tensor and mismatched shapes are refused."""
    from tpuslam_torch.kernels import _cuda
    left, right = _pair(stereo_pair, 64)
    disp, minsad = T.stereo_bm_plain(torch.as_tensor(left)[None],
                                     torch.as_tensor(right)[None],
                                     StereoBMConfig())
    _cuda.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.lr_check_cuda(disp, minsad, StereoBMConfig())
    with pytest.raises(ValueError):
        T.lr_check_cuda(disp, minsad[:, :32], StereoBMConfig())
    assert _cuda.LAUNCHES["lr_check"] == 0


def _lr_ref(disp, minsad, **kw):
    import jax
    import jax.numpy as jnp
    lr = jax.jit(J._lr_consistency, static_argnums=2)
    return np.asarray(lr(jnp.asarray(disp, jnp.int32),
                         jnp.asarray(minsad, jnp.int32),
                         JCfg(**kw))).astype(np.int16)


def _lr_port(disp, minsad, **kw):
    return T._lr_consistency(torch.as_tensor(disp)[None],
                             torch.as_tensor(minsad)[None],
                             StereoBMConfig(**kw))[0].numpy()


@pytest.mark.parametrize("rows", [None, 376])
def test_lr_consistency_bit_equal(stereo_pair, rows):
    """The plain version of K5 against tpuslam's _lr_consistency (the XLA
    twin of the Pallas _lr_kernel) on the fixture's StereoBM output."""
    left, right = _pair(stereo_pair, rows)
    disp, minsad = _port(left, right)
    ref = _lr_ref(disp, minsad)
    got = _lr_port(disp, minsad)
    np.testing.assert_array_equal(got, ref)
    assert 0 < (got != disp).sum() < 0.05 * disp.size   # it does filter


@pytest.mark.parametrize("max_diff", [0, 1, 3])
def test_lr_consistency_occlusions(rng, max_diff):
    """A textured background at disparity 8 behind a box at disparity 24:
    the box occludes background pixels in the right view, which the check
    invalidates; equal to tpuslam's bit for bit."""
    h, w = 64, 200
    bg = rng.integers(0, 256, (h, w + 40), dtype=np.uint8)
    fg = rng.integers(0, 256, (h, w + 40), dtype=np.uint8)
    left = bg[:, 8:8 + w].copy()
    right = bg[:, :w].copy()
    left[16:48, 100:150] = fg[16:48, 124:174]
    right[16:48, 76:126] = fg[16:48, 124:174]
    kw = dict(disp12_max_diff=max_diff)
    disp, minsad = _port(left, right)
    got = _lr_port(disp, minsad, **kw)
    np.testing.assert_array_equal(got, _lr_ref(disp, minsad, **kw))
    assert (got != disp).any()


@pytest.mark.parametrize("rows", [None, 376])
def test_default_config_bit_equal(stereo_pair, rows):
    """stereo_bm in SlamConfig()'s StereoBM settings (LR check on) on the
    CPU equals tpuslam's stereo_bm without speckle."""
    from tpuslam.config import SlamConfig as JSlam
    from tpuslam_torch.config import SlamConfig
    left, right = _pair(stereo_pair, rows)
    ref = np.asarray(J.stereo_bm(left, right, JSlam().bm,
                                 with_speckle=False))
    got = T.stereo_bm(torch.as_tensor(left)[None],
                      torch.as_tensor(right)[None], SlamConfig().bm)
    np.testing.assert_array_equal(got[0].numpy(), ref)
