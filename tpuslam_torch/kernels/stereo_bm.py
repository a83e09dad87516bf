"""Dense SAD block-matching disparity (StereoBM) and its left-right check:
plain PyTorch versions and the dispatchers to the hand-written CUDA
kernels (csrc/stereo_bm.cu, csrc/lr_check.cu).

Counterpart of tpuslam/kernels/stereo_bm.py (`prefilter_xsobel`,
`_box_sum`, `stereo_bm`) and of the Pallas strip kernel
tpuslam/kernels/stereo_bm_pallas.py:_bm_strip_kernel, which is
bit-identical to `stereo_bm`.  Semantics are OpenCV's
findStereoCorrespondenceBM: X-Sobel prefilter capped at `prefilter_cap`,
(2r+1)^2 SAD over `num_disparities` shifts, winner with ties to the larger
disparity, uniqueness and texture gates, x16 subpixel with C-truncating
division, and (min_disparity - 1) * 16 at invalid pixels.  The
left-right check (`_lr_consistency`, cv::validateDisparity) is the twin
of tpuslam/kernels/stereo_bm.py:_lr_consistency and of the Pallas kernel
tpuslam/kernels/stereo_bm_pallas.py:_lr_kernel.

The speckle filter (`speckle_filter`, `speckle_filter_batch`, the twins
of tpuslam/kernels/stereo_bm.py's speckle_filter_with_flag and
speckle_filter_batch) labels connected components by min-label hooking (a
scatter-min over the edges) with pointer jumping until every edge joins
equal labels, where the reference runs a fixed 16 rounds for the TPU's
sake and returns whether they converged; it is plain PyTorch on both
devices (the reference computes it outside any Pallas kernel).
"""

from __future__ import annotations

from collections import deque

import torch

from ..config import StereoBMConfig
from . import _cuda

FILTERED_SCALE = 16  # x16 fixed-point disparity (DISP_SCALE)


def prefilter_xsobel(img: torch.Tensor, cap: int = 31) -> torch.Tensor:
    """X-Sobel prefilter of (..., H, W) uint8, clipped to [0, 2*cap]:
    reflect-101 rows, replicated columns for the derivative, first and last
    column forced to `cap` (OpenCV prefilterXSobel)."""
    x = img.to(torch.int32)
    h = x.shape[-2]
    up = torch.cat([x[..., 1:2, :], x[..., :-1, :]], dim=-2)
    down = torch.cat([x[..., 1:, :], x[..., h - 2:h - 1, :]], dim=-2)

    def dx(row):
        left = torch.cat([row[..., :1], row[..., :-1]], dim=-1)
        right = torch.cat([row[..., 1:], row[..., -1:]], dim=-1)
        return right - left

    v = torch.clamp(dx(up) + 2 * dx(x) + dx(down), -cap, cap) + cap
    v[..., 0] = cap
    v[..., -1] = cap
    return v.to(torch.uint8)


def prefilter_xsobel_hw(img: torch.Tensor) -> torch.Tensor:
    """The PL xsbl2 block's 6-bit offset-binary prefilter of (..., H, W)
    uint8, integer throughout (tpuslam's prefilter_xsobel_hw, bit-exact
    with the reference's xsbl2.v and its golden data):
      interior   = clamp(sobel_x, -32, 31) + 32
      cols 0,W-1 = 0x20 (forced)
      rows 0,H-1 = 0    (never written by the 3-line pipeline)
    Plain PyTorch on both devices: tpuslam computes it in XLA."""
    x = img.to(torch.int32)
    d = torch.cat([x[..., 1:], x[..., -1:]], dim=-1) - \
        torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    s = torch.zeros_like(x)
    s[..., 1:-1, :] = d[..., :-2, :] + 2 * d[..., 1:-1, :] + d[..., 2:, :]
    v = torch.clamp(s, -32, 31) + 32
    v[..., 0] = 0x20
    v[..., -1] = 0x20
    v[..., 0, :] = 0
    v[..., -1, :] = 0
    return v.to(torch.uint8)


def _vbox_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)-row window sum of (..., H, W) integers with zero padding,
    exact, via an integral image over rows (int64)."""
    h = x.shape[-2]
    dev = x.device
    c = torch.nn.functional.pad(torch.cumsum(x, dim=-2), (0, 0, 1, 0))
    top = torch.clamp(torch.arange(h, device=dev) - radius, 0, h)
    bot = torch.clamp(torch.arange(h, device=dev) + radius + 1, 0, h)
    return c.index_select(-2, bot) - c.index_select(-2, top)


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 window sum of (..., H, W) integers with zero padding,
    exact, via integral images: the row sums, then the same over columns."""
    w = x.shape[-1]
    r = radius
    dev = x.device
    c2 = torch.nn.functional.pad(torch.cumsum(_vbox_sum(x, r), dim=-1),
                                 (1, 0))
    lft = torch.clamp(torch.arange(w, device=dev) - r, 0, w)
    rgt = torch.clamp(torch.arange(w, device=dev) + r + 1, 0, w)
    return (c2.index_select(-1, rgt) - c2.index_select(-1, lft)).to(x.dtype)


# Phases of StereoBM, in order; each cut of the computation is a phase of
# the K1 harness (csrc/stereo_bm.cu `Phase`, tpuslam_torch/tools/
# probe_bm_parts.py).  Internal order is j = ndisp-1-d, cost_rev[j] the
# window SAD at j.  The two outputs of each phase, per (B, H, W) pixel:
#   prefilter  the prefiltered left and right images (uint8)
#   vbox       the vertical (2r+1)-row sum of plane j = 0, and the sum over
#              all ndisp+1 planes (texture and disparities) of theirs
#   boxes      cost_rev[0], and the texture box sum + sum_j cost_rev[j]
#   winner     best_j (internal), minsad
#   sad        cost_rev[best_j-1] (0 at best_j = 0) and cost_rev[best_j+1]
#              (0 at best_j = ndisp-1), before the edge swap
#   uniq       the uniqueness flag (0/1), minsad
#   full       disparity (int16) and minsad, StereoBM's own outputs
# Every output is int32 except where noted.
PHASES = ("prefilter", "vbox", "boxes", "winner", "sad", "uniq", "full")


def _check_phase(phase: str) -> None:
    if phase not in PHASES:
        raise ValueError(f"unknown StereoBM phase {phase!r}: {PHASES}")


def _sad_planes(lp, rp, cfg: StereoBMConfig):
    """The texture plane |Lp - ftzero| and the (ndisp, H, W) absolute
    differences |Lp(x) - Rp(x - d)| in internal order (plane j holds
    d = ndisp-1-j), zero right pixels for x < d; int32 in, int32 out."""
    ndisp = cfg.num_disparities
    h, w = lp.shape
    rshift = torch.zeros((ndisp, h, w), dtype=torch.int32, device=lp.device)
    for d in range(ndisp):
        rshift[ndisp - 1 - d, :, d:] = rp[:, :w - d]
    return (lp - cfg.prefilter_cap).abs(), (lp[None] - rshift).abs()


def _winner(cost_rev):
    """The first minimum over j, i.e. ties go to the larger disparity ->
    (minsad, best_j)."""
    ndisp = cost_rev.shape[0]
    jj = torch.arange(ndisp, device=cost_rev.device).view(ndisp, 1, 1)
    minsad = cost_rev.amin(dim=0)
    best_j = torch.where(cost_rev == minsad, jj, ndisp).amin(dim=0)
    return minsad, best_j


def _neighbour_sads(cost_rev, best_j):
    """(cost_rev[best_j-1], cost_rev[best_j+1]), each 0 where it falls
    outside [0, ndisp)."""
    ndisp = cost_rev.shape[0]
    lo = cost_rev.gather(0, (best_j - 1).clamp(min=0)[None])[0]
    hi = cost_rev.gather(0, (best_j + 1).clamp(max=ndisp - 1)[None])[0]
    return (torch.where(best_j > 0, lo, 0),
            torch.where(best_j < ndisp - 1, hi, 0))


def _uniqueness(cost_rev, minsad, best_j, ratio: int):
    """False where a cost more than one step from best_j lies within
    `ratio` percent of minsad."""
    if ratio <= 0:
        return torch.ones_like(best_j, dtype=torch.bool)
    ndisp = cost_rev.shape[0]
    jj = torch.arange(ndisp, device=cost_rev.device).view(ndisp, 1, 1)
    thresh = minsad + (minsad * ratio) // 100
    far = (jj - best_j[None]).abs() > 1
    return ~((cost_rev <= thresh[None]) & far).any(dim=0)


def _epilogue(minsad, best_j, sad_n, sad_p, tex, uniq_ok,
              cfg: StereoBMConfig):
    """x16 subpixel from the neighbour SADs and the validity gates ->
    (H, W) int32 disparity, (mindisp - 1) * 16 where invalid."""
    ndisp = cfg.num_disparities
    r = cfg.block_size // 2
    mindisp = cfg.min_disparity
    h, w = minsad.shape
    dev = minsad.device
    # sad[-1] := sad[1] and sad[ndisp] := sad[ndisp-2] in internal order
    sad_n, sad_p = (torch.where(best_j == 0, sad_p, sad_n),
                    torch.where(best_j == ndisp - 1, sad_n, sad_p))
    denom = sad_p + sad_n - 2 * minsad + (sad_p - sad_n).abs()
    num = (sad_p - sad_n) * 256
    # C integer division truncates toward zero
    frac = torch.where(denom != 0,
                       num.sign() * (num.abs() // denom.clamp(min=1)), 0)
    disp16 = ((ndisp - 1 - best_j + mindisp) * 256 + frac + 15) >> 4
    ys = torch.arange(h, device=dev).view(h, 1)
    xs = torch.arange(w, device=dev).view(1, w)
    valid = ((ys >= r) & (ys < h - r) &
             (xs >= mindisp + ndisp - 1 + r) & (xs < w - r) &
             (tex >= cfg.texture_threshold) & uniq_ok)
    return torch.where(valid, disp16, (mindisp - 1) * FILTERED_SCALE)


def _stereo_bm_frame(left, right, cfg: StereoBMConfig, phase: str = "full"):
    """One (H, W) uint8 pair -> the two outputs of `phase` (see PHASES);
    "full" gives (disp int16, minsad int32)."""
    r = cfg.block_size // 2
    lp = prefilter_xsobel(left, cfg.prefilter_cap)
    rp = prefilter_xsobel(right, cfg.prefilter_cap)
    if phase == "prefilter":
        return lp, rp
    i32 = torch.int32
    tex_plane, planes = _sad_planes(lp.to(i32), rp.to(i32), cfg)
    if phase == "vbox":
        v = _vbox_sum(planes, r)
        return (v[0].to(i32),
                (_vbox_sum(tex_plane, r) + v.sum(dim=0)).to(i32))
    cost_rev = _box_sum(planes, r)
    tex = _box_sum(tex_plane, r)
    if phase == "boxes":
        return cost_rev[0], tex + cost_rev.sum(dim=0, dtype=i32)
    minsad, best_j = _winner(cost_rev)
    if phase == "winner":
        return best_j.to(i32), minsad
    sad_n, sad_p = _neighbour_sads(cost_rev, best_j)
    if phase == "sad":
        return sad_n, sad_p
    uniq_ok = _uniqueness(cost_rev, minsad, best_j, cfg.uniqueness_ratio)
    if phase == "uniq":
        return uniq_ok.to(i32), minsad
    disp = _epilogue(minsad, best_j, sad_n, sad_p, tex, uniq_ok, cfg)
    return disp.to(torch.int16), minsad


def _stack_frames(left, right, cfg, phase):
    """Frames run one at a time to bound the (ndisp, H, W) cost volume."""
    outs = [_stereo_bm_frame(l, r, cfg, phase) for l, r in zip(left, right)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def stereo_bm_plain(left: torch.Tensor, right: torch.Tensor,
                    cfg: StereoBMConfig = StereoBMConfig()):
    """Plain PyTorch StereoBM over (B, H, W) uint8 pairs ->
    (disp (B, H, W) int16, minsad (B, H, W) int32)."""
    _cuda.PLAIN_CALLS["stereo_bm"] += 1
    return _stack_frames(left, right, cfg, "full")


def stereo_bm_phase_plain(left: torch.Tensor, right: torch.Tensor,
                          cfg: StereoBMConfig, phase: str):
    """Plain PyTorch StereoBM over (B, H, W) uint8 pairs cut after `phase`
    -> its two (B, H, W) outputs (PHASES gives them and their types); the
    twin of the K1 phase harness."""
    _check_phase(phase)
    _cuda.PLAIN_CALLS["stereo_bm_phase"] += 1
    return _stack_frames(left, right, cfg, phase)


# K1's packed kernel keeps its vertical sums and costs as two 16-bit lanes
# of a 32-bit word: a cost is at most 2 * prefilter_cap * block_size**2
K1_MAX_COST = 65535


def k1_packed_refusal(cfg: StereoBMConfig) -> Exception | None:
    """Why K1's packed kernel (the main path's, and the one the phase
    harness cuts) cannot take `cfg`, or None where it can: costs within its
    16-bit lanes (2 * cap * block**2 <= 65535), 64 disparities, an odd
    block of 3..31.  K1 runs every other configuration in its wide
    kernel."""
    max_cost = 2 * cfg.prefilter_cap * cfg.block_size ** 2
    if max_cost > K1_MAX_COST:
        return ValueError(
            f"prefilter_cap {cfg.prefilter_cap}, block_size "
            f"{cfg.block_size}: a SAD reaches 2 * cap * block**2 = "
            f"{max_cost} > {K1_MAX_COST}, K1's uint16 cost limit")
    if cfg.num_disparities != 64:
        return NotImplementedError(
            "K1's packed kernel is built for num_disparities=64")
    if cfg.block_size % 2 == 0 or not 3 <= cfg.block_size <= 31:
        return ValueError(f"block_size {cfg.block_size}: odd, 3..31")
    return None


def _check_bm_args(left, right, cfg: StereoBMConfig, packed: bool) -> None:
    """What kernel K1 takes: with `packed` (the phase harness) only what
    k1_packed_refusal lets through, checked first so that it is refused
    whatever the tensors; a CUDA uint8 (B, H, W) pair of at least 3x3
    pixels; at least one disparity and a block of at least one pixel."""
    refusal = k1_packed_refusal(cfg) if packed else None
    if refusal is not None:
        raise refusal
    _cuda.expect(left, "left", torch.uint8, 3)
    _cuda.expect(right, "right", torch.uint8, 3)
    if right.shape != left.shape or right.device != left.device:
        raise ValueError("left/right must share shape and device")
    if cfg.num_disparities < 1 or cfg.block_size < 1:
        raise ValueError(f"num_disparities {cfg.num_disparities}, "
                         f"block_size {cfg.block_size}: each at least 1")
    if left.shape[1] < 3 or left.shape[2] < 3:
        raise ValueError("image smaller than 3x3")


def _bm_params(left, cfg: StereoBMConfig):
    B, H, W = left.shape
    return (B, H, W, cfg.block_size // 2, cfg.min_disparity,
            cfg.prefilter_cap, cfg.uniqueness_ratio, cfg.texture_threshold)


def stereo_bm_cuda(left: torch.Tensor, right: torch.Tensor,
                   cfg: StereoBMConfig = StereoBMConfig()):
    """Kernel K1 (csrc/stereo_bm.cu): same contract as stereo_bm_plain.
    Its packed kernel where k1_packed_refusal is None, else its wide
    kernel: the choice is made from the configuration alone."""
    _check_bm_args(left, right, cfg, packed=False)
    wide = k1_packed_refusal(cfg) is not None
    lp = torch.empty_like(left)          # prefiltered images (scratch)
    rp = torch.empty_like(right)
    disp = torch.empty_like(left, dtype=torch.int16)
    minsad = torch.empty_like(left, dtype=torch.int32)
    with torch.cuda.device(left.device):
        _cuda.launch("stereo_bm", left, right, lp, rp, disp, minsad,
                     *_bm_params(left, cfg), cfg.num_disparities, int(wide))
    return disp, minsad


def stereo_bm_phase_cuda(left: torch.Tensor, right: torch.Tensor,
                         cfg: StereoBMConfig, phase: str):
    """The K1 phase harness (csrc/stereo_bm.cu, tpuslam_stereo_bm_phase):
    K1's prefilter launch and, past `prefilter`, K1's kernel cut after
    `phase`.  Same contract as stereo_bm_phase_plain, for the
    configurations of K1's packed kernel; no plain fallback."""
    _check_phase(phase)
    _check_bm_args(left, right, cfg, packed=True)
    lp = torch.empty_like(left)
    rp = torch.empty_like(right)
    if phase == "prefilter":
        outs = (lp, rp)
    else:
        outs = (torch.empty_like(left, dtype=torch.int16 if phase == "full"
                                 else torch.int32),
                torch.empty_like(left, dtype=torch.int32))
    with torch.cuda.device(left.device):
        _cuda.launch("stereo_bm_phase", left, right, lp, rp, *outs,
                     *_bm_params(left, cfg), PHASES.index(phase))
    return outs


def _lr_consistency(disp: torch.Tensor, minsad: torch.Tensor,
                    cfg: StereoBMConfig) -> torch.Tensor:
    """Left-right consistency (cv::validateDisparity) over (B, H, W)
    int16 disparity and int32 min-SAD -> (B, H, W) int16; the reference's
    static-shift form, step for step.

    Projection pass: every participating left pixel x (valid, x >=
    mindisp + ndisp) projects its winner to x2 = x - round(d/16); each
    right pixel keeps the projector of least (minsad * 4096 + dv).  Check
    pass: x is invalidated only when both its floor projection x - (d>>4)
    and its ceil projection x - ((d+15)>>4) hold valid winners differing
    from d by more than disp12MaxDiff * 16."""
    disp = disp.to(torch.int32)
    minsad = minsad.to(torch.int32)
    B, h, w = disp.shape
    dev = disp.device
    mindisp = cfg.min_disparity
    ndisp = cfg.num_disparities
    filtered = (mindisp - 1) * FILTERED_SCALE
    INF = 2 ** 31 - 1

    xs = torch.arange(w, device=dev, dtype=torch.int32)
    participate = (disp != filtered) & (xs >= max(mindisp + ndisp, 0))
    dint = (disp + FILTERED_SCALE // 2) >> 4            # round(d/16)
    dv = disp - mindisp * FILTERED_SCALE
    enc = torch.where(participate, minsad * 4096 + dv, INF)

    P = ndisp + abs(mindisp) + 2

    def pad(x, lo, hi):
        return torch.cat([torch.full((B, h, P), lo, dtype=torch.int32,
                                     device=dev), x,
                          torch.full((B, h, P), hi, dtype=torch.int32,
                                     device=dev)], dim=2)

    enc_pad = pad(enc, INF, INF)
    dint_pad = pad(dint, 1 << 20, INF)
    best2 = torch.full((B, h, w), INF, dtype=torch.int32, device=dev)
    for k in range(mindisp, mindisp + ndisp + 1):
        # right pixel x2 sees left pixel x = x2 + k
        sl = enc_pad[..., P + k:P + k + w]
        sd = dint_pad[..., P + k:P + k + w]
        best2 = torch.minimum(best2, torch.where(sd == k, sl, INF))
    disp2 = torch.where(best2 != INF,
                        torch.remainder(best2, 4096) +
                        mindisp * FILTERED_SCALE, filtered)

    md16 = cfg.disp12_max_diff * FILTERED_SCALE
    disp2_pad = pad(disp2, filtered, filtered)

    def fails(s):
        """d2 = disp2[x - s(x)] through static shifts, 0 where s(x) lies
        outside [mindisp, mindisp + ndisp]."""
        xp = xs - s
        inb = (xp >= 0) & (xp < w)
        d2 = torch.zeros((B, h, w), dtype=torch.int32, device=dev)
        for k in range(mindisp, mindisp + ndisp + 1):
            d2 = torch.where(s == k, disp2_pad[..., P - k:P - k + w], d2)
        return inb & (d2 >= 0) & ((d2 - disp).abs() > md16)

    bad = participate & fails(disp >> 4) & \
        fails((disp + FILTERED_SCALE - 1) >> 4)
    return torch.where(bad, filtered, disp).to(torch.int16)


def lr_check_plain(disp: torch.Tensor, minsad: torch.Tensor,
                   cfg: StereoBMConfig = StereoBMConfig()) -> torch.Tensor:
    """Plain version of kernel K5: `_lr_consistency`, counted."""
    _cuda.PLAIN_CALLS["lr_check"] += 1
    return _lr_consistency(disp, minsad, cfg)


def lr_check_cuda(disp: torch.Tensor, minsad: torch.Tensor,
                  cfg: StereoBMConfig = StereoBMConfig()) -> torch.Tensor:
    """Kernel K5 (csrc/lr_check.cu): same contract as lr_check_plain, on
    K1's (B, H, W) int16 disparity and int32 min-SAD."""
    _cuda.expect(disp, "disp", torch.int16, 3)
    _cuda.expect(minsad, "minsad", torch.int32, 3)
    if minsad.shape != disp.shape or minsad.device != disp.device:
        raise ValueError("disp/minsad must share shape and device")
    B, H, W = disp.shape
    out = torch.empty_like(disp)
    with torch.cuda.device(disp.device):
        _cuda.launch("lr_check", disp, minsad, out, B, H, W,
                     cfg.min_disparity, cfg.num_disparities,
                     cfg.disp12_max_diff * FILTERED_SCALE)
    return out


def lr_check_kernel_attrs(width: int) -> dict:
    """Registers, shared bytes (static and dynamic) and local bytes per
    thread of K5's kernel at image width `width` (64 disparities from 0)
    on the current card, its rows (a warp each) and threads per block
    there, and its columns per lane and pass."""
    out = _cuda.attributes("lr_check", "tpuslam_lr_check_attrs", 6, width)
    return dict(zip(("registers", "shared_bytes", "local_bytes", "rows",
                     "threads", "columns_per_lane"), out))


def lr_check(disp, minsad, cfg: StereoBMConfig = StereoBMConfig()):
    """A CUDA tensor goes to kernel K5, a CPU tensor to the plain
    version."""
    fn = lr_check_cuda if disp.is_cuda else lr_check_plain
    return fn(disp, minsad, cfg)


# hook rounds of the speckle filter between two convergence checks (each
# check reads one flag on the host)
SPECKLE_CHECK_EVERY = 2
# the rounds that each speckle call ran before its check found the labels
# converged, newest last
SPECKLE_ROUNDS: deque = deque(maxlen=4096)


def _speckle_edges(d: torch.Tensor, max_diff: int, filtered: int):
    """The 4-connectivity of (B, H, W) int32 disparity: (right, down), True
    where a pixel and its right (lower) neighbour both differ from
    `filtered` and from each other by at most `max_diff`."""
    valid = d != filtered
    right = valid[..., :, 1:] & valid[..., :, :-1] & \
        ((d[..., :, 1:] - d[..., :, :-1]).abs() <= max_diff)
    down = valid[..., 1:, :] & valid[..., :-1, :] & \
        ((d[..., 1:, :] - d[..., :-1, :]).abs() <= max_diff)
    return right, down


def speckle_labels(d: torch.Tensor, max_diff: int, filtered: int):
    """Connected components of (B, H, W) int32 disparity: every pixel's
    label becomes the least flat index (over the whole batch) of its
    component.  A round hooks, for every edge (u, v), the label of u's
    label to v's label if that is less, and the other way round (a
    scatter-min), then jumps each pointer twice (label of the label).  A
    label is never above its own index and always one of its component's,
    so where every edge joins equal labels each label is its component's
    least index; that is checked every SPECKLE_CHECK_EVERY rounds.  No
    edge crosses frames, so neither does a label.  Returns (labels int64,
    rounds run)."""
    right, down = _speckle_edges(d, max_diff, filtered)
    idx = torch.arange(d.numel(), device=d.device).view(d.shape)
    u = torch.cat([idx[..., :, :-1][right], idx[..., :-1, :][down]])
    v = torch.cat([idx[..., :, 1:][right], idx[..., 1:, :][down]])
    labels = idx.view(-1).clone()
    rounds = 0
    while True:
        for _ in range(SPECKLE_CHECK_EVERY):
            lu, lv = labels[u], labels[v]
            labels.scatter_reduce_(0, lu, lv, "amin")
            labels.scatter_reduce_(0, lv, lu, "amin")
            labels = labels[labels]
            labels = labels[labels]
        rounds += SPECKLE_CHECK_EVERY
        if torch.equal(labels[u], labels[v]):
            return labels.view(d.shape), rounds


def speckle_filter_batch(disp: torch.Tensor, max_size: int, max_diff: int,
                         filtered: int) -> torch.Tensor:
    """cv::filterSpeckles over a (B, H, W) batch: 4-connected components
    whose neighbours differ by at most `max_diff` (raw disparity units, as
    OpenCV's StereoBM passes speckleRange), pixels equal to `filtered`
    left out of every component; components of at most `max_size` pixels
    become `filtered`.  Returns the filtered disparity, of disp's dtype.
    The labels run to their fixpoint, so unlike tpuslam's fixed 16 rounds
    there is no convergence flag; SPECKLE_ROUNDS gets the rounds run."""
    labels, rounds = speckle_labels(disp.to(torch.int32), max_diff,
                                    filtered)
    SPECKLE_ROUNDS.append(rounds)
    flat = labels.view(-1)
    size = torch.bincount(flat, minlength=flat.numel())[flat]
    return torch.where((size <= max_size).view(disp.shape),
                       torch.tensor(filtered, dtype=disp.dtype,
                                    device=disp.device), disp)


def speckle_filter(disp: torch.Tensor, max_size: int, max_diff: int,
                   filtered: int) -> torch.Tensor:
    """speckle_filter_batch of one (H, W) map (tpuslam's
    speckle_filter_with_flag, without its flag)."""
    return speckle_filter_batch(disp[None], max_size, max_diff,
                                filtered)[0]


def speckle_bm(disp: torch.Tensor,
               cfg: StereoBMConfig = StereoBMConfig()) -> torch.Tensor:
    """StereoBM's speckle pass over (B, H, W) disparity in `cfg`'s window
    and range (none where the window is 0 or the range negative)."""
    if cfg.speckle_window_size <= 0 or cfg.speckle_range < 0:
        return disp
    return speckle_filter_batch(disp, cfg.speckle_window_size,
                                cfg.speckle_range,
                                (cfg.min_disparity - 1) * FILTERED_SCALE)


def stereo_bm_lr(left: torch.Tensor, right: torch.Tensor,
                 cfg: StereoBMConfig = StereoBMConfig()) -> torch.Tensor:
    """StereoBM and its left-right check (when `disp12_max_diff >= 0`),
    without the speckle pass: kernels K1 and K5 for a CUDA tensor, the
    plain versions for a CPU tensor.  Nothing here waits for the card."""
    fn = stereo_bm_cuda if left.is_cuda else stereo_bm_plain
    disp, minsad = fn(left, right, cfg)
    if cfg.disp12_max_diff >= 0:
        disp = lr_check(disp, minsad, cfg)
    return disp


def stereo_bm(left: torch.Tensor, right: torch.Tensor,
              cfg: StereoBMConfig = StereoBMConfig(),
              with_speckle: bool = True) -> torch.Tensor:
    """(B, H, W) uint8 pairs -> (B, H, W) int16 x16 disparity, with the
    left-right check when `disp12_max_diff >= 0` and, with `with_speckle`,
    the speckle pass (`speckle_bm`), as tpuslam's stereo_bm.

    A CUDA tensor goes to kernels K1 and K5, a CPU tensor to the plain
    versions."""
    disp = stereo_bm_lr(left, right, cfg)
    return speckle_bm(disp, cfg) if with_speckle else disp


# the wide kernel's launch shape (csrc/stereo_bm.cu
# tpuslam_stereo_bm_wide_shape), in its order
WIDE_SHAPE_KEYS = ("rows", "planes_per_group", "planes_per_chunk", "staged",
                   "shared_bytes", "registers", "blocks_per_sm")


def stereo_bm_wide_shape(cfg: StereoBMConfig) -> dict:
    """The launch shape K1's wide kernel takes for `cfg` on the current
    card (WIDE_SHAPE_KEYS): output rows per block, planes per group and
    per right-image chunk, whether the tile is staged in shared memory
    (else the global kernel, for a radius whose tile does not fit), shared
    bytes per block, registers per thread and blocks per SM."""
    out = _cuda.attributes("stereo_bm", "tpuslam_stereo_bm_wide_shape", 7,
                           cfg.num_disparities, cfg.block_size // 2)
    return dict(zip(WIDE_SHAPE_KEYS, out))


def _packed_occupancy(phase: str, cfg: StereoBMConfig) -> tuple:
    """csrc/stereo_bm.cu tpuslam_stereo_bm_phase_occupancy for `cfg`:
    (registers, shared bytes, blocks per SM, sub-bands a tile)."""
    refusal = k1_packed_refusal(cfg)
    if refusal is not None:
        raise refusal
    return _cuda.attributes("stereo_bm", "tpuslam_stereo_bm_phase_occupancy",
                            4, PHASES.index(phase), cfg.block_size // 2)


def stereo_bm_packed_shape(cfg: StereoBMConfig = StereoBMConfig()) -> dict:
    """The launch shape K1's packed kernel takes for `cfg` on the current
    card: output rows and columns per block, sub-bands of 8 rows per
    tile, shared bytes per block, registers per thread and blocks per
    SM."""
    regs, smem, blocks, nsb = _packed_occupancy("full", cfg)
    return dict(rows=8 * nsb, columns=32, sub_bands=nsb, shared_bytes=smem,
                registers=regs, blocks_per_sm=blocks)


def stereo_bm_phase_occupancy(phase: str,
                              cfg: StereoBMConfig = StereoBMConfig()):
    """(registers per thread, shared bytes per block, blocks per SM) of the
    harness's K1 kernel cut after `phase` (not `prefilter`) for `cfg` on
    the current card; every cut runs at K1's (`full`) blocks per SM."""
    _check_phase(phase)
    if phase == "prefilter":
        raise ValueError("the prefilter phase runs no cut of K1's kernel")
    return _packed_occupancy(phase, cfg)[:3]
