"""Semi-global block matching (SGBM, MODE_HH), in plain PyTorch.

Counterpart of tpuslam/kernels/sgbm.py (the reference's selectable SGBM
depth engine, main.cpp:218-244: cv::StereoSGBM minDisparity -64,
numDisparities 128, blockSize 11, P1 100, P2 1000, disp12MaxDiff 32,
preFilterCap 0, uniquenessRatio 15, speckleWindowSize 1000, speckleRange
16, MODE_HH).  tpuslam computes it in XLA (lax.scan, no Pallas kernel), so
this port is plain PyTorch on both devices and equals tpuslam's bit for
bit: every stage is integer.

  * `_bt_cost`: Birchfield-Tomasi pixel cost on two channels (the clipped
    3-row x-Sobel at full weight, the intensity >> 2) over the valid-x
    region [max(maxD, 0), W + min(minD, 0));
  * `_box_sum_region`: (block x block) box sum with replicate borders on
    the region grid;
  * `_aggregate`: the 8 SGM paths of MODE_HH, L_r(p, d) = C(p, d) +
    min(L_r(p-r, d), L_r(p-r, d+-1) + P1, min L_r(p-r) + P2) - min
    L_r(p-r), summed into one S in place;
  * winner (first minimum), uniqueness, x16 subpixel with C-truncating
    division, the left-right check and the speckle pass.

Memory and launches.  A 1241x376 frame at SGBMConfig() has a
376 x 1113 x 128 cost volume (107 MB as int16, 214 MB as int32), so a
batch runs in groups of frames (`group_size`) whose volumes stay under
`GROUP_BYTES`.  tpuslam's scans stack each direction's outputs; here each
step adds its slab into S.  The three downward paths (vertical and both
diagonals) share one (3, G, W1, D) carry, the three upward ones another,
and the two horizontal paths one (2, G, H, D) carry with the second
direction walking from the right: the sums are integer, so the order of
the additions leaves S unchanged, and a step's ~10 launches serve three
(two) paths.

The speckle pass is the port's `speckle_filter_batch`, which runs to its
fixpoint and so equals cv2.filterSpeckles; tpuslam's `_speckle_filter`
runs a fixed 16 rounds, which do not converge on real maps (ROADMAP C).
"""

from __future__ import annotations

import torch

from ..config import SGBMConfig
from .stereo_bm import speckle_filter_batch

DISP_SCALE = 16
_INF = 1 << 29
# the int32 volumes of one group of frames (C, S and the stages'
# temporaries, PEAK_VOLUMES of them at once) stay under this many bytes
GROUP_BYTES = 12 << 30
PEAK_VOLUMES = 6


def _region(w: int, cfg: SGBMConfig) -> tuple[int, int]:
    """(minX1, W1): the first column and the width of the valid region."""
    max_d = cfg.min_disparity + cfg.num_disparities
    min_x1 = max(max_d, 0)
    return min_x1, w + min(cfg.min_disparity, 0) - min_x1


def _sobel3(img: torch.Tensor) -> torch.Tensor:
    """3-row x-derivative of calcPixelCostBT over (..., H, W):
    (row[x+1]-row[x-1])*2 + up[x+1]-up[x-1] + down[x+1]-down[x-1], rows
    clamped, x borders 0."""
    im = img.to(torch.int32)
    up = torch.cat([im[..., :1, :], im[..., :-1, :]], dim=-2)
    dn = torch.cat([im[..., 1:, :], im[..., -1:, :]], dim=-2)

    def dx(a):
        z = torch.zeros_like(a[..., :1])
        return torch.cat([z, a[..., 2:] - a[..., :-2], z], dim=-1)

    return dx(im) * 2 + dx(up) + dx(dn)


def _minmax3(a: torch.Tensor):
    """Per-pixel min/max over {a, (a+left)/2, (a+right)/2} (BT half-pixel
    interpolation; every operand is non-negative, so floor division is
    C's)."""
    al = (a + torch.cat([a[..., :1], a[..., :-1]], dim=-1)) // 2
    ar = (a + torch.cat([a[..., 1:], a[..., -1:]], dim=-1)) // 2
    lo = torch.minimum(torch.minimum(a, al), ar)
    hi = torch.maximum(torch.maximum(a, al), ar)
    return lo, hi


def _bt_cost(left: torch.Tensor, right: torch.Tensor,
             cfg: SGBMConfig) -> torch.Tensor:
    """(B, H, W1, D) int16 two-channel BT pixel cost over the valid
    region of (B, H, W) uint8 pairs."""
    w = left.shape[-1]
    min_d, D = cfg.min_disparity, cfg.num_disparities
    min_x1, W1 = _region(w, cfg)
    max_x1 = min_x1 + W1
    ftzero = max(cfg.prefilter_cap, 15) | 1

    def tab(img):
        s = torch.clamp(_sobel3(img), -ftzero, ftzero) + ftzero
        s[..., 0] = ftzero
        s[..., -1] = ftzero
        return s

    channels = []
    for u, v, shift in ((tab(left), tab(right), 0),
                        (left.to(torch.int32), right.to(torch.int32), 2)):
        v0, v1 = _minmax3(v)
        u0, u1 = _minmax3(u)
        channels.append((u[..., min_x1:max_x1], u0[..., min_x1:max_x1],
                         u1[..., min_x1:max_x1], v, v0, v1, shift))
    # both channels' sum is at most 2 * 15 + 255 // 4 = 93: tpuslam casts
    # it to int16 (sgbm.py:121), which changes no value
    cost = torch.empty(left.shape[:-1] + (W1, D), dtype=torch.int16,
                       device=left.device)
    for d_i in range(D):
        lo = min_x1 - (min_d + d_i)
        total = None
        for uu, uu0, uu1, v, v0, v1, shift in channels:
            vv, vv0, vv1 = (t[..., lo:lo + W1] for t in (v, v0, v1))
            c0 = torch.clamp(torch.maximum(uu - vv1, vv0 - uu), min=0)
            c1 = torch.clamp(torch.maximum(vv - uu1, uu0 - vv), min=0)
            c = torch.minimum(c0, c1) >> shift
            total = c if total is None else total + c
        cost[..., d_i] = total
    return cost


def _box_sum_region(c: torch.Tensor, sw: int) -> torch.Tensor:
    """(B, H, W1, D) box sum over (sw x sw), int32, with replicate borders
    on the region grid (OpenCV clamps the window inside [minX1, maxX1)):
    each axis padded with r copies of its first and last slab, then a
    cumulative sum differenced sw apart."""
    x = c.to(torch.int32)
    if sw <= 1:
        return x
    r = sw // 2
    for dim in (2, 1):
        n = x.shape[dim]
        first = x.narrow(dim, 0, 1)
        last = x.narrow(dim, n - 1, 1)
        pad = torch.cat([first] * r + [x] + [last] * r, dim=dim)
        cs = torch.cumsum(pad, dim=dim, dtype=torch.int32)
        del pad
        head = cs.narrow(dim, sw - 1, 1)
        tail = cs.narrow(dim, sw, n + 2 * r - sw) - \
            cs.narrow(dim, 0, n + 2 * r - sw)
        x = torch.cat([head, tail], dim=dim)
    return x


def _sgm_step(Lp: torch.Tensor, c_slab: torch.Tensor, P1: int,
              P2: int) -> torch.Tensor:
    """One SGM recurrence step over a (..., D) carry Lp -> L for this
    slab; d - 1 and d + 1 outside [0, D) cost _INF."""
    min_lp = Lp.amin(dim=-1, keepdim=True)
    pad = torch.nn.functional.pad(Lp, (1, 1), value=_INF)
    best = torch.minimum(torch.minimum(pad[..., :-2], pad[..., 2:]) + P1,
                         Lp)
    best = torch.minimum(best, min_lp + P2)
    return c_slab + best - min_lp


def _aggregate(C: torch.Tensor, P1: int, P2: int) -> torch.Tensor:
    """Sum of all 8 SGM directions over (B, H, W1, D) int32 costs.

    tpuslam's eight lax.scans, folded into three loops that add each
    step's slab into S: the horizontal pair (left -> right walks column t
    while right -> left walks column W1-1-t), the downward triple
    (vertical, predecessor x-1, predecessor x+1) and the upward triple.
    A predecessor outside [0, W1) is 0, as in tpuslam."""
    B, H, W1, D = C.shape
    dev = C.device
    S = torch.zeros_like(C)

    # horizontal: carry (2, B, H, D)
    L = torch.zeros((2, B, H, D), dtype=torch.int32, device=dev)
    ts = torch.arange(W1, device=dev)
    pairs = torch.stack([ts, W1 - 1 - ts], dim=1)
    for t in range(W1):
        cols = pairs[t]
        slab = C.index_select(2, cols).permute(2, 0, 1, 3)
        L = _sgm_step(L, slab, P1, P2)
        S.index_add_(2, cols, L.permute(1, 2, 0, 3))

    # vertical and diagonal: the carry sits in a (3, B, W1 + 2, D) buffer
    # with zero border columns, so the shifted predecessors are views
    for rows in (range(H), range(H - 1, -1, -1)):
        buf = torch.zeros((3, B, W1 + 2, D), dtype=torch.int32, device=dev)
        for y in rows:
            Lp = torch.stack([buf[0, :, 1:W1 + 1], buf[1, :, 0:W1],
                              buf[2, :, 2:W1 + 2]])
            L = _sgm_step(Lp, C[:, y], P1, P2)
            buf[:, :, 1:W1 + 1] = L
            S[:, y] += L.sum(dim=0, dtype=torch.int32)
    return S


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C integer division (truncation toward zero): torch's `//` floors,
    and the subpixel numerators go negative."""
    return torch.div(a, b, rounding_mode="trunc")


def _winner(S: torch.Tensor):
    """(minS, best) over the last axis of S: the least cost and the first
    disparity that has it (tpuslam's min over where(S == minS, d, D))."""
    D = S.shape[-1]
    ds = torch.arange(D, dtype=torch.int32, device=S.device)
    minS = S.amin(dim=-1)
    best = torch.where(S == minS[..., None], ds, D).amin(dim=-1)
    return minS, torch.clamp(best, max=D - 1)


def group_size(h: int, w: int, cfg: SGBMConfig) -> int:
    """Frames per group: PEAK_VOLUMES int32 (H, W1, D) volumes each,
    within GROUP_BYTES."""
    _, W1 = _region(w, cfg)
    per_frame = PEAK_VOLUMES * 4 * h * max(W1, 1) * cfg.num_disparities
    return max(1, GROUP_BYTES // per_frame)


def _sgbm_group(left: torch.Tensor, right: torch.Tensor,
                cfg: SGBMConfig) -> torch.Tensor:
    """sgbm without the speckle pass over one group of (G, H, W) pairs."""
    G, h, w = left.shape
    dev = left.device
    min_d, D = cfg.min_disparity, cfg.num_disparities
    min_x1, W1 = _region(w, cfg)
    P1 = max(cfg.p1, 1)
    P2 = max(cfg.p2, P1 + 1)
    INVALID = (min_d - 1) * DISP_SCALE

    S = _aggregate(_box_sum_region(_bt_cost(left, right, cfg),
                                   cfg.block_size), P1, P2)

    minS, best = _winner(S)
    ds = torch.arange(D, dtype=torch.int32, device=dev)

    valid = torch.ones((G, h, W1), dtype=torch.bool, device=dev)
    if cfg.uniqueness_ratio > 0:
        far = (ds - best[..., None]).abs() > 1
        bad = (S * (100 - cfg.uniqueness_ratio) < minS[..., None] * 100) & far
        valid &= ~bad.any(dim=-1)
        del far, bad

    # x16 subpixel (quadratic, C-truncating division)
    bm1 = torch.clamp(best - 1, 0, D - 1).long()
    bp1 = torch.clamp(best + 1, 0, D - 1).long()
    Sm1 = S.gather(-1, bm1[..., None])[..., 0]
    Sp1 = S.gather(-1, bp1[..., None])[..., 0]
    del S
    interior = (best > 0) & (best < D - 1)
    denom2 = torch.clamp(Sm1 + Sp1 - 2 * minS, min=1)
    sub = best * DISP_SCALE + _trunc_div(
        (Sm1 - Sp1) * DISP_SCALE + denom2, denom2 * 2)
    disp = torch.where(interior, sub, best * DISP_SCALE) + min_d * DISP_SCALE

    # left-right consistency (disp12MaxDiff): each left pixel's best
    # hypothesis competes for its right pixel rx = x_full - (minD + best);
    # losers whose floor and ceil checks both fail are invalidated
    if cfg.disp12_max_diff >= 0:
        xs_full = torch.arange(W1, dtype=torch.int32, device=dev) + min_x1
        d_abs = best + min_d
        rx = xs_full - d_abs
        rx_ok = (rx >= 0) & (rx < w)
        rx_idx = torch.where(rx_ok, rx, w).long()    # column w: the dump
        # (cost, disparity) in one int for one scatter-min; OFF makes the
        # disparity term non-negative
        OFF = D + abs(min_d) + 2
        enc = minS * (2 * OFF) + (d_abs + OFF)
        enc = torch.where(rx_ok & valid, enc, _INF)
        # tpuslam's .at[rows, rx_idx].min(enc) into a (h, w + 1) map
        disp2 = torch.full((G, h, w + 1), _INF, dtype=torch.int32,
                           device=dev)
        disp2.scatter_reduce_(2, rx_idx, enc, "amin", include_self=True)
        # % floors in both frameworks; enc >= 0 here anyway
        disp2_d = torch.where(disp2 >= _INF, min_d - 1,
                              disp2 % (2 * OFF) - OFF)[..., :w]

        # >> is arithmetic on negative int32 in both frameworks
        d_floor = disp >> 4
        d_ceil = (disp + DISP_SCALE - 1) >> 4

        def fails(dq):
            x = xs_full - dq
            d2 = disp2_d.gather(2, torch.clamp(x, 0, w - 1).long())
            return (x >= 0) & (x < w) & (d2 >= min_d) & \
                ((d2 - dq).abs() > cfg.disp12_max_diff)
        valid &= ~(fails(d_floor) & fails(d_ceil))

    region = torch.where(valid, disp, INVALID).to(torch.int16)
    out = torch.full((G, h, w), INVALID, dtype=torch.int16, device=dev)
    # the region's write at minX1 (tpuslam's dynamic_update_slice)
    out[..., min_x1:min_x1 + W1] = region
    return out


def speckle_sgbm(disp: torch.Tensor,
                 cfg: SGBMConfig = SGBMConfig()) -> torch.Tensor:
    """SGBM's speckle pass over (B, H, W) disparity: SGBM passes
    DISP_SCALE * speckleRange to filterSpeckles (StereoBM passes it raw);
    none where the window is 0 or the range negative."""
    if cfg.speckle_window_size <= 0 or cfg.speckle_range < 0:
        return disp
    return speckle_filter_batch(disp, cfg.speckle_window_size,
                                cfg.speckle_range * DISP_SCALE,
                                (cfg.min_disparity - 1) * DISP_SCALE)


def sgbm(left, right, cfg: SGBMConfig = SGBMConfig(),
         with_speckle: bool = True, device="cuda") -> torch.Tensor:
    """(B, H, W) uint8 pairs -> (B, H, W) int16 disparity, x16 fixed point,
    on `device` (the card unless the caller asks for the CPU).  Invalid
    pixels hold (min_disparity-1)*16, OpenCV's INVALID_DISP_SCALED.  The
    frames run in groups of `group_size` frames; with `with_speckle` the
    batch then goes through `speckle_sgbm`."""
    left = torch.as_tensor(left, device=device)
    right = torch.as_tensor(right, device=device)
    if left.dim() != 3 or left.shape != right.shape or \
            left.dtype != torch.uint8 or right.dtype != torch.uint8:
        raise ValueError("sgbm takes two (B, H, W) uint8 pairs of one "
                         "shape")
    B, h, w = left.shape
    if _region(w, cfg)[1] < 1:
        raise ValueError(f"sgbm: width {w} leaves no valid region for "
                         f"{cfg.num_disparities} disparities from "
                         f"{cfg.min_disparity}")
    g = group_size(h, w, cfg)
    out = torch.cat([_sgbm_group(left[i:i + g], right[i:i + g], cfg)
                     for i in range(0, B, g)])
    return speckle_sgbm(out, cfg) if with_speckle else out
