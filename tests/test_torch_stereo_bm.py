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
    # minsad is int32, as the reference keeps it, and at most 62 * 21^2
    assert minsad.dtype == np.int32
    assert minsad.min() >= 0 and minsad.max() <= 62 * 441


def test_disparity_bit_equal_small_config(rng):
    """Another window and disparity count, on a synthetic shifted pair."""
    left = rng.integers(0, 256, (53, 197), dtype=np.uint8)
    right = np.roll(left, -5, axis=1)
    kw = dict(num_disparities=16, block_size=9, uniqueness_ratio=0)
    np.testing.assert_array_equal(_port(left, right, **kw)[0],
                                  _ref(left, right, **kw))


# configurations that K1 runs in its wide kernel (its packed kernel
# refuses each): the plain version, the wide kernel's twin on the card,
# against tpuslam's stereo_bm
WIDE_CONFIGS = {"ndisp32": dict(num_disparities=32),
                "ndisp128": dict(num_disparities=128, min_disparity=-5),
                "block33": dict(prefilter_cap=15, block_size=33),
                "block20": dict(block_size=20),
                "block1": dict(block_size=1, uniqueness_ratio=0),
                "cost": dict(prefilter_cap=63, block_size=23)}


@pytest.fixture(scope="module")
def wide_crop(stereo_pair):
    """64 rows x 320 columns of the fixture pair: wide enough that 128
    disparities and the halo leave valid pixels."""
    left, right = stereo_pair
    return (np.ascontiguousarray(left[200:264, 160:480]),
            np.ascontiguousarray(right[200:264, 160:480]))


@pytest.mark.parametrize("case", list(WIDE_CONFIGS))
def test_wide_configurations_bit_equal(wide_crop, case):
    kw = WIDE_CONFIGS[case]
    assert T.k1_packed_refusal(StereoBMConfig(**kw)) is not None
    ref = _ref(*wide_crop, **kw)
    disp, _ = _port(*wide_crop, **kw)
    np.testing.assert_array_equal(disp, ref)
    assert (ref >= 0).sum() > 0


def test_batch_dispatch_uses_plain_on_cpu(stereo_pair):
    from tpuslam_torch.kernels import _cuda
    left, right = _pair(stereo_pair, 96)
    lb = torch.as_tensor(np.stack([left, left[::-1].copy()]))
    rb = torch.as_tensor(np.stack([right, right[::-1].copy()]))
    _cuda.reset_counters()
    disp = T.stereo_bm(lb, rb, StereoBMConfig(**SLICE), with_speckle=False)
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


def _c1_pair():
    """A pair whose min-SAD passes 32767 at prefilter_cap 63 and block 25:
    the right image is the left one shifted by 20 columns under strong
    noise, so no disparity matches well."""
    rng = np.random.default_rng(145)
    base = rng.integers(0, 256, (64, 384)).astype(np.float64)
    base = np.stack([np.convolve(row, np.ones(2) / 2, "same")
                     for row in base])
    left = base[:, 80:304]
    right = base[:, 100:324] + rng.normal(0, 200, (64, 224))
    return (np.clip(left, 0, 255).astype(np.uint8),
            np.clip(right, 0, 255).astype(np.uint8))


def test_minsad_wider_than_int16():
    """Min-SAD above 32767 reaches the left-right check unwrapped: the
    port's stereo_bm equals tpuslam's bit for bit (with an int16 min-SAD
    it differed at 4 pixels).  K1's packed kernel, whose costs are 16-bit
    lanes, cannot take the configuration, so K1 runs it in its wide kernel
    (int32 costs; tests/test_torch_cuda.py::test_k1_wide_kernel), and the
    phase harness, which cuts the packed kernel, refuses it before any
    build or launch."""
    from tpuslam_torch.kernels import _cuda
    left, right = _c1_pair()
    kw = dict(prefilter_cap=63, block_size=25)
    ref = np.asarray(J.stereo_bm(left, right, JCfg(**kw),
                                 with_speckle=False))
    lt, rt = torch.as_tensor(left)[None], torch.as_tensor(right)[None]
    _cuda.reset_counters()
    np.testing.assert_array_equal(
        T.stereo_bm(lt, rt, StereoBMConfig(**kw),
                      with_speckle=False)[0].numpy(), ref)
    minsad = T.stereo_bm_plain(lt, rt, StereoBMConfig(**kw))[1]
    assert minsad.dtype == torch.int32 and int(minsad.max()) > 32767
    assert isinstance(T.k1_packed_refusal(StereoBMConfig(**kw)), ValueError)
    with pytest.raises(ValueError, match="uint16 cost limit"):
        T.stereo_bm_phase_cuda(lt, rt, StereoBMConfig(**kw), "full")
    assert _cuda.LAUNCHES["stereo_bm"] == 0
    assert _cuda.LAUNCHES["stereo_bm_phase"] == 0


@pytest.mark.parametrize("cap,block,accepted", [
    (63, 21, True), (63, 23, False), (31, 31, True), (34, 31, True),
    (35, 31, False)])
def test_k1_cost_limit(cap, block, accepted):
    """K1's packed kernel takes a configuration exactly when 2 * cap *
    block**2 <= 65535 (34 * 2 * 961 = 65348, 35 * 2 * 961 = 67270); the
    phase harness, which cuts that kernel, says so before it looks at the
    tensors.  K1 itself takes both (the others in its wide kernel), so it,
    like an accepted harness call, goes on to refuse CPU tensors."""
    from tpuslam_torch.kernels import _cuda
    img = torch.zeros((1, 40, 48), dtype=torch.uint8)
    cfg = StereoBMConfig(prefilter_cap=cap, block_size=block)
    assert (T.k1_packed_refusal(cfg) is None) == accepted
    _cuda.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.stereo_bm_cuda(img, img, cfg)
    with pytest.raises(ValueError, match="CUDA tensor" if accepted
                       else "uint16 cost limit"):
        T.stereo_bm_phase_cuda(img, img, cfg, "vbox")
    assert sum(_cuda.LAUNCHES.values()) == 0


# the edge of K1's packed kernel's domain: the largest cost it admits (cap
# 34, block 31: 2 * 34 * 31**2 = 65348) and the main path's block at the
# largest cap the prefilter is built for (63, block 21: 55566)
PACKED_EDGE = {"cap34_block31": dict(prefilter_cap=34, block_size=31),
               "cap63_block21": dict(prefilter_cap=63, block_size=21)}


def _sawtooth_pair(h=40, w=160):
    """A rising sawtooth (8 grey levels a pixel, period 32) on the left and
    the falling one on the right: the prefiltered left sits at 2 * cap and
    the right at 0 almost everywhere, so every cost comes near
    2 * cap * block**2 (tests/test_torch_cuda.py's card pair, cropped)."""
    ramp = (np.arange(w) % 32 * 8).astype(np.uint8)
    return (np.ascontiguousarray(np.broadcast_to(ramp, (h, w))),
            np.ascontiguousarray(np.broadcast_to(248 - ramp, (h, w))))


def _ref_minsad(left, right, **kw):
    """The min-SAD over the 64 disparities, from tpuslam's prefilter_xsobel
    and _box_sum (the XLA twin's own steps)."""
    cfg = JCfg(**SLICE, **kw)
    cap, r = cfg.prefilter_cap, cfg.block_size // 2
    lp = np.asarray(J.prefilter_xsobel(left, cap)).astype(np.int32)
    rp = np.asarray(J.prefilter_xsobel(right, cap)).astype(np.int32)
    rshift = np.zeros((cfg.num_disparities,) + lp.shape, np.int32)
    for d in range(cfg.num_disparities):
        rshift[d, :, d:] = rp[:, :lp.shape[1] - d]
    return np.asarray(J._box_sum(np.abs(lp[None] - rshift), r)).min(axis=0)


@pytest.mark.parametrize("pair", ["fixture", "sawtooth"])
@pytest.mark.parametrize("case", list(PACKED_EDGE))
def test_packed_edge_bit_equal(wide_crop, case, pair):
    """At the edge of K1's packed kernel's domain, the plain version (the
    twin the card holds that kernel to, tests/test_torch_cuda.py) equals
    tpuslam's stereo_bm bit for bit, disparity and min-SAD: on a crop of
    the fixture pair and on a sawtooth pair whose min-SAD passes 32767."""
    kw = PACKED_EDGE[case]
    assert T.k1_packed_refusal(StereoBMConfig(**kw)) is None
    left, right = wide_crop if pair == "fixture" else _sawtooth_pair()
    disp, minsad = _port(left, right, **kw)
    np.testing.assert_array_equal(disp, _ref(left, right, **kw))
    np.testing.assert_array_equal(minsad, _ref_minsad(left, right, **kw))
    if pair == "sawtooth":
        assert 2 ** 15 < int(minsad.max()) <= 65535
    else:
        assert (disp >= 0).sum() > 0


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


def _random_lr_inputs(rng, shape, mindisp, ndisp):
    """Random int16 disparities around [mindisp, mindisp + ndisp) * 16
    (a few outside it), ~20 % `filtered`, and int32 min-SAD below 2^19:
    the inputs of the card-only K5 edge tests."""
    lo, hi = mindisp * 16, (mindisp + ndisp) * 16
    disp = rng.integers(lo - 32, hi + 32, shape).astype(np.int16)
    disp[rng.uniform(size=shape) < 0.2] = (mindisp - 1) * 16
    return disp, rng.integers(0, 2 ** 19, shape).astype(np.int32)


@pytest.mark.parametrize("mindisp,ndisp,max_diff", [(-8, 16, 1), (5, 16, 0),
                                                    (5, 64, 3)])
def test_lr_consistency_random_offsets(mindisp, ndisp, max_diff):
    """The plain version of K5 against tpuslam's _lr_consistency on random
    disparity and min-SAD at nonzero min_disparity and at 16 disparities,
    2 frames of 8x97, bit for bit."""
    disp, minsad = _random_lr_inputs(np.random.default_rng(9), (2, 8, 97),
                                     mindisp, ndisp)
    kw = dict(min_disparity=mindisp, num_disparities=ndisp,
              disp12_max_diff=max_diff)
    got = T._lr_consistency(torch.as_tensor(disp), torch.as_tensor(minsad),
                            StereoBMConfig(**kw)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b],
                                      _lr_ref(disp[b], minsad[b], **kw))
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
                      torch.as_tensor(right)[None], SlamConfig().bm,
                      with_speckle=False)
    np.testing.assert_array_equal(got[0].numpy(), ref)


# --- the K1 phase harness's plain twin -------------------------------------

_I32 = (np.int32, np.int32)
PHASE_DTYPES = dict(prefilter=(np.uint8, np.uint8), vbox=_I32, boxes=_I32,
                    winner=_I32, sad=_I32, uniq=_I32,
                    full=(np.int16, np.int32))
# sha256 of stereo_bm_plain's (disp, minsad) bytes on _phase_pair(rng),
# taken from the code before StereoBM was split into phases, when minsad
# was int16
PLAIN_DIGEST = \
    "272f8e29120cfbf11c06a010abf9e371b003469f398a92f58e7151036ffaf098"


def _phase_pair(rng, n=2, h=48, w=200):
    """n frames whose right image is the left shifted by a row-varying
    disparity of 5..35 (tests/test_bm_pallas.py:17-28's construction)."""
    lefts, rights = [], []
    for _ in range(n):
        left = rng.integers(0, 256, (h, w), dtype=np.uint8)
        left = ((left.astype(np.int32) + np.roll(left, 1, 1) +
                 np.roll(left, 1, 0)) // 3).astype(np.uint8)
        right = np.empty_like(left)
        for y in range(h):
            right[y] = np.roll(left[y], -(20 + int(15 * np.sin(y / 7.0))))
        lefts.append(left)
        rights.append(right)
    return np.stack(lefts), np.stack(rights)


def _vertical_sum(x, r):
    """Direct (2r+1)-row sum with zero padding, in numpy."""
    h = x.shape[-2]
    out = np.zeros_like(x)
    for t in range(-r, r + 1):
        lo, hi = max(0, -t), min(h, h - t)
        out[..., lo:hi, :] += x[..., lo + t:hi + t, :]
    return out


def _ref_phase(left, right, phase):
    """One frame's two outputs of `phase`, built from tpuslam's XLA twin
    (prefilter_xsobel, _box_sum, and stereo_bm's winner, neighbour SADs,
    uniqueness and output at :490-528) in StereoBMConfig() without the
    left-right check and speckle; vbox, which has no counterpart there,
    from a direct numpy sum."""
    import jax.numpy as jnp
    cfg = JCfg(**SLICE)
    ndisp, r, ftzero = cfg.num_disparities, cfg.block_size // 2, \
        cfg.prefilter_cap
    lp = np.asarray(J.prefilter_xsobel(left, ftzero))
    rp = np.asarray(J.prefilter_xsobel(right, ftzero))
    if phase == "prefilter":
        return lp, rp
    lp, rp = lp.astype(np.int32), rp.astype(np.int32)
    h, w = lp.shape
    rshift = np.zeros((ndisp, h, w), np.int32)
    for d in range(ndisp):
        rshift[d, :, d:] = rp[:, :w - d]
    absdiff = np.abs(lp[None] - rshift)
    tex_plane = np.abs(lp - ftzero)
    if phase == "vbox":
        v = _vertical_sum(absdiff, r)
        return v[ndisp - 1], _vertical_sum(tex_plane, r) + v.sum(axis=0)
    cost_rev = jnp.asarray(np.asarray(J._box_sum(absdiff, r))[::-1])
    tex = np.asarray(J._box_sum(tex_plane, r))
    if phase == "boxes":
        return np.asarray(cost_rev[0]), tex + np.asarray(cost_rev).sum(0)
    mind = jnp.argmin(cost_rev, axis=0)
    minsad = jnp.min(cost_rev, axis=0)
    if phase == "winner":
        return np.asarray(mind), np.asarray(minsad)
    if phase == "sad":
        def at(j):
            return jnp.take_along_axis(
                cost_rev, jnp.clip(j, 0, ndisp - 1)[None], axis=0)[0]
        return (np.asarray(jnp.where(mind > 0, at(mind - 1), 0)),
                np.asarray(jnp.where(mind < ndisp - 1, at(mind + 1), 0)))
    if phase == "uniq":
        thresh = minsad + (minsad * cfg.uniqueness_ratio) // 100
        far = jnp.abs(jnp.arange(ndisp).reshape(ndisp, 1, 1) -
                      mind[None]) > 1
        violate = jnp.any((cost_rev <= thresh[None]) & far, axis=0)
        return np.asarray(~violate), np.asarray(minsad)
    return (np.asarray(J.stereo_bm(left, right, cfg, with_speckle=False)),
            np.asarray(minsad))


@pytest.mark.parametrize("phase", list(PHASE_DTYPES))
def test_phase_plain_matches_reference(rng, phase):
    """The plain twin of each phase of the K1 harness, bit for bit against
    the same quantity built from tpuslam's XLA twin of the Pallas strip
    kernel (tests/test_bm_pallas.py pins the two bit-identical).  The TPU
    probe's own truncated kernels (tools/probe_bm_parts.py) cannot be
    imported: that script reads a cached KITTI sequence and turns on the
    compile cache when imported."""
    from tpuslam_torch.kernels import _cuda
    lefts, rights = _phase_pair(rng)
    _cuda.reset_counters()
    got = T.stereo_bm_phase_plain(torch.as_tensor(lefts),
                                  torch.as_tensor(rights),
                                  StereoBMConfig(**SLICE), phase)
    assert _cuda.PLAIN_CALLS["stereo_bm_phase"] == 1
    assert sum(_cuda.LAUNCHES.values()) == 0
    for i in range(len(lefts)):
        ref = _ref_phase(lefts[i], rights[i], phase)
        for g, want, dtype in zip(got, ref, PHASE_DTYPES[phase]):
            g = g[i].numpy()
            assert g.dtype == dtype
            np.testing.assert_array_equal(g.astype(np.int64),
                                          want.astype(np.int64))


def test_phase_full_is_stereo_bm_plain(rng):
    """The full phase is StereoBM itself, and splitting StereoBM into
    phases left stereo_bm_plain's outputs as they were (a digest taken
    before the split)."""
    import hashlib
    lefts, rights = (torch.as_tensor(a) for a in _phase_pair(rng))
    cfg = StereoBMConfig()
    disp, minsad = T.stereo_bm_plain(lefts, rights, cfg)
    full = T.stereo_bm_phase_plain(lefts, rights, cfg, "full")
    assert torch.equal(full[0], disp) and torch.equal(full[1], minsad)
    # minsad is int32 now; its values here are far below 32767, so the
    # int16 cast gives the same bytes the digest was taken of
    assert int(minsad.max()) < 2 ** 15
    digest = hashlib.sha256(disp.numpy().tobytes() +
                            minsad.to(torch.int16).numpy().tobytes()
                            ).hexdigest()
    assert digest == PLAIN_DIGEST
    assert (disp >= 0).any()


def test_phase_wrappers_refuse(rng):
    """An unknown phase is refused by both versions, CPU tensors by the
    kernel's wrapper, the prefilter by the occupancy query, before any
    build or launch."""
    from tpuslam_torch.kernels import _cuda
    lefts, rights = (torch.as_tensor(a) for a in _phase_pair(rng, n=1))
    _cuda.reset_counters()
    for fn in (T.stereo_bm_phase_cuda, T.stereo_bm_phase_plain):
        with pytest.raises(ValueError, match="unknown StereoBM phase"):
            fn(lefts, rights, StereoBMConfig(), "pass1")
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.stereo_bm_phase_cuda(lefts, rights, StereoBMConfig(), "full")
    with pytest.raises(ValueError, match="no cut"):
        T.stereo_bm_phase_occupancy("prefilter")
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert sum(_cuda.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize("kw", [dict(num_disparities=32),
                                dict(prefilter_cap=35, block_size=31),
                                dict(block_size=33, prefilter_cap=15)])
def test_packed_queries_refuse(kw):
    """The packed kernel's shape and occupancy queries refuse a
    configuration the packed kernel does not take, with its refusal, before
    any build or launch."""
    from tpuslam_torch.kernels import _cuda
    cfg = StereoBMConfig(**kw)
    refusal = T.k1_packed_refusal(cfg)
    assert refusal is not None
    _cuda.reset_counters()
    for query in (T.stereo_bm_packed_shape,
                  lambda c: T.stereo_bm_phase_occupancy("full", c)):
        with pytest.raises(type(refusal), match=str(refusal)[:20]):
            query(cfg)
    assert sum(_cuda.LAUNCHES.values()) == 0


def test_k1_bound_at_the_integer_rate():
    """K1's integer work is bound at OPS_32, the rate the card has for it:
    an SM's 64 INT32 lanes issue K1's packed instructions (a VABSDIFF4's
    four byte differences, an add's two 16-bit sums on a word), and every
    value K1 sums fits 16 bits, so is exact in FP32 too.  6 operations a
    pixel and disparity on the main path's 30-frame chunk: 0.0802 ms, more
    than its 8 bytes a pixel take (0.0334 ms)."""
    from tpuslam_torch.tools import timing
    assert timing.OPS_32 == 67e12
    px = 30 * 376 * 1241
    ms, by = timing.bound(8 * px, 6 * 64 * px)
    assert by == "operations" and abs(ms - 0.08023) < 1e-5
    assert abs(8 * px / timing.HBM_BPS * 1e3 - 0.03343) < 1e-5


def test_probe_needs_the_card(monkeypatch):
    """The harness exits with an error where there is no CUDA device.  Its
    bound model gives the full phase the bytes of K1's own function (the
    pair in, disparity and min-SAD out) and every phase's operations; a
    phase adds bytes only where its outputs grow (the prefiltered pair,
    then two int32 planes; the full phase's int16 disparity and int32
    min-SAD are fewer)."""
    from tpuslam_torch.tools import probe_bm_parts as PB
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        PB.main()
    added, (full_bytes, full_ops) = PB.phase_work(1)
    assert list(added) == list(T.PHASES)
    assert full_bytes == 8
    assert full_ops == sum(o for _, o in added.values())
    assert [b for b, _ in added.values()] == [4, 6, 0, 0, 0, 0, 0]


# configurations outside kernel K1's packed kernel (tpuslam's strip kernel
# computes each), and the default one inside it: (StereoBMConfig keywords,
# the packed kernel takes it)
K1_ENVELOPE = {"default": ({}, True),
               "ndisp32": (dict(num_disparities=32), False),
               "block33": (dict(prefilter_cap=15, block_size=33), False),
               "cost": (dict(prefilter_cap=63, block_size=23), False),
               "block20": (dict(block_size=20), False)}


@pytest.mark.parametrize("case", list(K1_ENVELOPE))
def test_dispatch_choice_on_the_card(monkeypatch, case):
    """The StereoBM dispatcher sends every CUDA tensor to kernel K1 and
    every CPU tensor to the plain version; K1 runs its packed kernel
    exactly where k1_packed_refusal is None, else its wide kernel.  Read on
    the CPU with a stand-in CUDA tensor and recording twins, and with K1's
    launcher and its CUDA checks stood in for, so nothing is built."""
    import contextlib
    from types import SimpleNamespace
    from tpuslam_torch.kernels import _cuda
    kw, packed = K1_ENVELOPE[case]
    cfg = StereoBMConfig(disp12_max_diff=-1, **kw)
    assert (T.k1_packed_refusal(cfg) is None) == packed
    called = []
    with monkeypatch.context() as m:
        m.setattr(T, "stereo_bm_cuda",
                  lambda *a: called.append("kernel") or (1, 2))
        m.setattr(T, "stereo_bm_plain",
                  lambda *a: called.append("plain") or (1, 2))
        card = SimpleNamespace(is_cuda=True)
        T.stereo_bm_lr(card, card, cfg)
        T.stereo_bm_lr(torch.zeros(1, 4, 4, dtype=torch.uint8), None, cfg)
    assert called == ["kernel", "plain"]
    launched = []
    monkeypatch.setattr(_cuda, "expect", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, "launch",
                        lambda name, *a: launched.append((name, a[-2:])))
    img = torch.zeros((1, 40, 48), dtype=torch.uint8)
    T.stereo_bm_cuda(img, img, cfg)
    assert launched == [("stereo_bm", (cfg.num_disparities, int(not packed)))]
