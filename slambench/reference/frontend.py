"""The plain reference of the front end that the timed path runs: dense
disparity (StereoBM with its left-right check, or SGBM), GFTT corners
with greedy min-distance suppression and the ORB border filter, ORB
descriptors at the GFTT angle, the 3D lift and the map nodes' decimated
disparity.

Plain PyTorch (on whatever device the inputs are) and NumPy.  It imports
nothing of the program: every function here is a frozen copy of a plain
version in tpuslam_torch/kernels/ (stereo_bm.py, sgbm.py, gftt.py,
orb.py) or of the lift in tpuslam_torch/vo/fused.py, except the keypoint
selection, which is written anew as the sequential greedy loop whose
result the program's blockwise fixpoint
(gftt.select_from_candidates_device) computes.  The camera comes from the
calib.txt text the benchmark wrote, the ORB sampling pattern from this
folder's copy of OpenCV's bit_pattern_31.

`low=True` computes the control: the same reference one precision step
down where a later change would be tempted to take it, float16 sums for
StereoBM's integer costs and bfloat16 for SGBM's aggregated costs (whose
sums pass float16's range) and for every float32 stage.  The control
has to fail the comparison (slambench/check.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

DISP_SCALE = 16
_HERE = os.path.dirname(os.path.abspath(__file__))
# the robot frame from the optical one (x forward, y left, z up)
LOCAL_TRANSFORM = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                            [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                           np.float32)


def read_calib(path: str) -> dict:
    """P0 and P1 of a KITTI calib.txt as float64 (3, 4) arrays."""
    out = {}
    with open(path) as fh:
        for line in fh:
            key, _, vals = line.partition(":")
            if key.strip() in ("P0", "P1"):
                out[key.strip()] = np.array([float(v) for v in vals.split()],
                                            np.float64).reshape(3, 4)
    return out


# ---------------------------------------------------------------------------
# StereoBM and its left-right check (kernels/stereo_bm.py)
# ---------------------------------------------------------------------------

def prefilter_xsobel(img: torch.Tensor, cap: int) -> torch.Tensor:
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


def _cumsum(x: torch.Tensor, dim: int, low: bool) -> torch.Tensor:
    """An exact int64 running sum, or the control's float16 one."""
    if low:
        return torch.cumsum(x.to(torch.float16), dim=dim,
                            dtype=torch.float16).to(torch.int64)
    return torch.cumsum(x, dim=dim)


def _box_sum(x: torch.Tensor, radius: int, low: bool) -> torch.Tensor:
    """(2r+1)^2 window sum of (..., H, W) integers with zero padding via
    integral images: rows, then columns."""
    h, w = x.shape[-2:]
    r = radius
    dev = x.device
    c = torch.nn.functional.pad(_cumsum(x, -2, low), (0, 0, 1, 0))
    top = torch.clamp(torch.arange(h, device=dev) - r, 0, h)
    bot = torch.clamp(torch.arange(h, device=dev) + r + 1, 0, h)
    v = c.index_select(-2, bot) - c.index_select(-2, top)
    c2 = torch.nn.functional.pad(_cumsum(v, -1, low), (1, 0))
    lft = torch.clamp(torch.arange(w, device=dev) - r, 0, w)
    rgt = torch.clamp(torch.arange(w, device=dev) + r + 1, 0, w)
    return (c2.index_select(-1, rgt) - c2.index_select(-1, lft)).to(x.dtype)


def _bm_frame(left, right, cfg: dict, low: bool):
    """One (H, W) uint8 pair -> (disparity int16 x16, min-SAD int32):
    OpenCV's findStereoCorrespondenceBM."""
    ndisp = cfg["num_disparities"]
    mindisp = cfg["min_disparity"]
    r = cfg["block_size"] // 2
    cap = cfg["prefilter_cap"]
    i32 = torch.int32
    lp = prefilter_xsobel(left, cap).to(i32)
    rp = prefilter_xsobel(right, cap).to(i32)
    h, w = lp.shape
    dev = lp.device
    rshift = torch.zeros((ndisp, h, w), dtype=i32, device=dev)
    for d in range(ndisp):                 # plane j holds d = ndisp-1-j
        rshift[ndisp - 1 - d, :, d:] = rp[:, :w - d]
    cost = _box_sum((lp[None] - rshift).abs(), r, low)
    tex = _box_sum((lp - cap).abs(), r, low)

    jj = torch.arange(ndisp, device=dev).view(ndisp, 1, 1)
    minsad = cost.amin(dim=0)
    best = torch.where(cost == minsad, jj, ndisp).amin(dim=0)
    lo = cost.gather(0, (best - 1).clamp(min=0)[None])[0]
    hi = cost.gather(0, (best + 1).clamp(max=ndisp - 1)[None])[0]
    sad_n = torch.where(best > 0, lo, 0)
    sad_p = torch.where(best < ndisp - 1, hi, 0)
    ratio = cfg["uniqueness_ratio"]
    if ratio > 0:
        thresh = minsad + (minsad * ratio) // 100
        far = (jj - best[None]).abs() > 1
        uniq = ~((cost <= thresh[None]) & far).any(dim=0)
    else:
        uniq = torch.ones_like(best, dtype=torch.bool)
    sad_n, sad_p = (torch.where(best == 0, sad_p, sad_n),
                    torch.where(best == ndisp - 1, sad_n, sad_p))
    denom = sad_p + sad_n - 2 * minsad + (sad_p - sad_n).abs()
    num = (sad_p - sad_n) * 256
    frac = torch.where(denom != 0,
                       num.sign() * (num.abs() // denom.clamp(min=1)), 0)
    disp16 = ((ndisp - 1 - best + mindisp) * 256 + frac + 15) >> 4
    ys = torch.arange(h, device=dev).view(h, 1)
    xs = torch.arange(w, device=dev).view(1, w)
    valid = ((ys >= r) & (ys < h - r) &
             (xs >= mindisp + ndisp - 1 + r) & (xs < w - r) &
             (tex >= cfg["texture_threshold"]) & uniq)
    disp = torch.where(valid, disp16, (mindisp - 1) * DISP_SCALE)
    return disp.to(torch.int16), minsad.to(i32)


def _lr_check(disp: torch.Tensor, minsad: torch.Tensor, cfg: dict):
    """cv::validateDisparity over (B, H, W) int16 disparity and int32
    min-SAD, in its static-shift form."""
    disp = disp.to(torch.int32)
    B, h, w = disp.shape
    dev = disp.device
    mindisp = cfg["min_disparity"]
    ndisp = cfg["num_disparities"]
    filtered = (mindisp - 1) * DISP_SCALE
    INF = 2 ** 31 - 1
    xs = torch.arange(w, device=dev, dtype=torch.int32)
    participate = (disp != filtered) & (xs >= max(mindisp + ndisp, 0))
    dint = (disp + DISP_SCALE // 2) >> 4
    enc = torch.where(participate,
                      minsad * 4096 + (disp - mindisp * DISP_SCALE), INF)
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
        sl = enc_pad[..., P + k:P + k + w]
        sd = dint_pad[..., P + k:P + k + w]
        best2 = torch.minimum(best2, torch.where(sd == k, sl, INF))
    disp2 = torch.where(best2 != INF, torch.remainder(best2, 4096) +
                        mindisp * DISP_SCALE, filtered)
    md16 = cfg["disp12_max_diff"] * DISP_SCALE
    disp2_pad = pad(disp2, filtered, filtered)

    def fails(s):
        xp = xs - s
        inb = (xp >= 0) & (xp < w)
        d2 = torch.zeros((B, h, w), dtype=torch.int32, device=dev)
        for k in range(mindisp, mindisp + ndisp + 1):
            d2 = torch.where(s == k, disp2_pad[..., P - k:P - k + w], d2)
        return inb & (d2 >= 0) & ((d2 - disp).abs() > md16)

    bad = participate & fails(disp >> 4) & \
        fails((disp + DISP_SCALE - 1) >> 4)
    return torch.where(bad, filtered, disp).to(torch.int16)


def stereo_bm(left, right, cfg: dict, low: bool = False) -> torch.Tensor:
    """(B, H, W) uint8 pairs -> (B, H, W) int16 x16 disparity with the
    left-right check where disp12_max_diff >= 0 (no speckle pass)."""
    outs = [_bm_frame(lf, rt, cfg, low) for lf, rt in zip(left, right)]
    disp = torch.stack([o[0] for o in outs])
    if cfg["disp12_max_diff"] >= 0:
        disp = _lr_check(disp, torch.stack([o[1] for o in outs]), cfg)
    return disp


# ---------------------------------------------------------------------------
# SGBM, MODE_HH (kernels/sgbm.py, without its speckle pass)
# ---------------------------------------------------------------------------

_INF = 1 << 29


def _region(w: int, cfg: dict) -> tuple[int, int]:
    max_d = cfg["min_disparity"] + cfg["num_disparities"]
    min_x1 = max(max_d, 0)
    return min_x1, w + min(cfg["min_disparity"], 0) - min_x1


def _sobel3(img):
    im = img.to(torch.int32)
    up = torch.cat([im[..., :1, :], im[..., :-1, :]], dim=-2)
    dn = torch.cat([im[..., 1:, :], im[..., -1:, :]], dim=-2)

    def dx(a):
        z = torch.zeros_like(a[..., :1])
        return torch.cat([z, a[..., 2:] - a[..., :-2], z], dim=-1)

    return dx(im) * 2 + dx(up) + dx(dn)


def _minmax3(a):
    al = (a + torch.cat([a[..., :1], a[..., :-1]], dim=-1)) // 2
    ar = (a + torch.cat([a[..., 1:], a[..., -1:]], dim=-1)) // 2
    return (torch.minimum(torch.minimum(a, al), ar),
            torch.maximum(torch.maximum(a, al), ar))


def _bt_cost(left, right, cfg: dict):
    """(B, H, W1, D) two-channel Birchfield-Tomasi cost."""
    w = left.shape[-1]
    min_d, D = cfg["min_disparity"], cfg["num_disparities"]
    min_x1, W1 = _region(w, cfg)
    max_x1 = min_x1 + W1
    ftzero = max(cfg["prefilter_cap"], 15) | 1

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
    cost = torch.empty(left.shape[:-1] + (W1, D), dtype=torch.int32,
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


def _box_sum_region(x, sw: int):
    """(sw x sw) box sum with replicate borders on the region grid."""
    if sw <= 1:
        return x
    r = sw // 2
    for dim in (2, 1):
        n = x.shape[dim]
        first = x.narrow(dim, 0, 1)
        last = x.narrow(dim, n - 1, 1)
        pad = torch.cat([first] * r + [x] + [last] * r, dim=dim)
        cs = torch.cumsum(pad, dim=dim, dtype=torch.int32)
        head = cs.narrow(dim, sw - 1, 1)
        tail = cs.narrow(dim, sw, n + 2 * r - sw) - \
            cs.narrow(dim, 0, n + 2 * r - sw)
        x = torch.cat([head, tail], dim=dim)
    return x


def _sgm_step(Lp, c_slab, P1: int, P2: int, inf):
    min_lp = Lp.amin(dim=-1, keepdim=True)
    pad = torch.nn.functional.pad(Lp, (1, 1), value=inf)
    best = torch.minimum(torch.minimum(pad[..., :-2], pad[..., 2:]) + P1,
                         Lp)
    best = torch.minimum(best, min_lp + P2)
    return c_slab + best - min_lp


def _aggregate(C, P1: int, P2: int, low: bool):
    """Sum of the 8 SGM paths; int32, or the control's bfloat16."""
    B, H, W1, D = C.shape
    dev = C.device
    dt = torch.bfloat16 if low else torch.int32
    inf = 3e38 if low else _INF
    C = C.to(dt)
    S = torch.zeros_like(C)
    L = torch.zeros((2, B, H, D), dtype=dt, device=dev)
    ts = torch.arange(W1, device=dev)
    pairs = torch.stack([ts, W1 - 1 - ts], dim=1)
    for t in range(W1):
        cols = pairs[t]
        slab = C.index_select(2, cols).permute(2, 0, 1, 3)
        L = _sgm_step(L, slab, P1, P2, inf)
        S.index_add_(2, cols, L.permute(1, 2, 0, 3))
    for rows in (range(H), range(H - 1, -1, -1)):
        buf = torch.zeros((3, B, W1 + 2, D), dtype=dt, device=dev)
        for y in rows:
            Lp = torch.stack([buf[0, :, 1:W1 + 1], buf[1, :, 0:W1],
                              buf[2, :, 2:W1 + 2]])
            L = _sgm_step(Lp, C[:, y], P1, P2, inf)
            buf[:, :, 1:W1 + 1] = L
            S[:, y] += L.sum(dim=0, dtype=dt)
    return S.to(torch.int32) if low else S


def sgbm(left, right, cfg: dict, low: bool = False) -> torch.Tensor:
    """(G, H, W) uint8 pairs -> (G, H, W) int16 x16 disparity."""
    G, h, w = left.shape
    dev = left.device
    min_d, D = cfg["min_disparity"], cfg["num_disparities"]
    min_x1, W1 = _region(w, cfg)
    P1 = max(cfg["p1"], 1)
    P2 = max(cfg["p2"], P1 + 1)
    INVALID = (min_d - 1) * DISP_SCALE
    S = _aggregate(_box_sum_region(_bt_cost(left, right, cfg),
                                   cfg["block_size"]), P1, P2, low)
    ds = torch.arange(D, dtype=torch.int32, device=dev)
    minS = S.amin(dim=-1)
    best = torch.clamp(torch.where(S == minS[..., None], ds, D)
                       .amin(dim=-1), max=D - 1)
    valid = torch.ones((G, h, W1), dtype=torch.bool, device=dev)
    if cfg["uniqueness_ratio"] > 0:
        far = (ds - best[..., None]).abs() > 1
        bad = (S * (100 - cfg["uniqueness_ratio"]) <
               minS[..., None] * 100) & far
        valid &= ~bad.any(dim=-1)
    bm1 = torch.clamp(best - 1, 0, D - 1).long()
    bp1 = torch.clamp(best + 1, 0, D - 1).long()
    Sm1 = S.gather(-1, bm1[..., None])[..., 0]
    Sp1 = S.gather(-1, bp1[..., None])[..., 0]
    del S
    interior = (best > 0) & (best < D - 1)
    denom2 = torch.clamp(Sm1 + Sp1 - 2 * minS, min=1)
    sub = best * DISP_SCALE + torch.div(
        (Sm1 - Sp1) * DISP_SCALE + denom2, denom2 * 2, rounding_mode="trunc")
    disp = torch.where(interior, sub, best * DISP_SCALE) + min_d * DISP_SCALE
    if cfg["disp12_max_diff"] >= 0:
        xs_full = torch.arange(W1, dtype=torch.int32, device=dev) + min_x1
        d_abs = best + min_d
        rx = xs_full - d_abs
        rx_ok = (rx >= 0) & (rx < w)
        rx_idx = torch.where(rx_ok, rx, w).long()
        OFF = D + abs(min_d) + 2
        enc = minS * (2 * OFF) + (d_abs + OFF)
        enc = torch.where(rx_ok & valid, enc, _INF)
        disp2 = torch.full((G, h, w + 1), _INF, dtype=torch.int32,
                           device=dev)
        disp2.scatter_reduce_(2, rx_idx, enc, "amin", include_self=True)
        disp2_d = torch.where(disp2 >= _INF, min_d - 1,
                              disp2 % (2 * OFF) - OFF)[..., :w]
        d_floor = disp >> 4
        d_ceil = (disp + DISP_SCALE - 1) >> 4

        def fails(dq):
            x = xs_full - dq
            d2 = disp2_d.gather(2, torch.clamp(x, 0, w - 1).long())
            return (x >= 0) & (x < w) & (d2 >= min_d) & \
                ((d2 - dq).abs() > cfg["disp12_max_diff"])
        valid &= ~(fails(d_floor) & fails(d_ceil))
    region = torch.where(valid, disp, INVALID).to(torch.int16)
    out = torch.full((G, h, w), INVALID, dtype=torch.int16, device=dev)
    out[..., min_x1:min_x1 + W1] = region
    return out


# ---------------------------------------------------------------------------
# GFTT corners (kernels/gftt.py) and the greedy selection
# ---------------------------------------------------------------------------

def _reflect101_pad(x, r: int):
    top = x[..., 1:r + 1, :].flip(-2)
    bot = x[..., -r - 1:-1, :].flip(-2)
    x = torch.cat([top, x, bot], dim=-2)
    left = x[..., :, 1:r + 1].flip(-1)
    right = x[..., :, -r - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _sep_filter(x, kcol, krow):
    p = _reflect101_pad(x, 1)
    v = kcol[0] * p[..., :-2, :] + kcol[1] * p[..., 1:-1, :] + \
        kcol[2] * p[..., 2:, :]
    return krow[0] * v[..., :, :-2] + krow[1] * v[..., :, 1:-1] + \
        krow[2] * v[..., :, 2:]


def gftt_response(img, block_size: int, low: bool = False):
    """cv::cornerMinEigenVal (ksize 3 Sobel, unnormalised box, 8U
    scale); float32, or the control's bfloat16."""
    h, w = img.shape[-2:]
    x = img.to(torch.bfloat16 if low else torch.float32)
    scale = 1.0 / ((1 << 2) * block_size * 255.0)
    dx = _sep_filter(x, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)) * scale
    dy = _sep_filter(x, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0)) * scale
    r = block_size // 2

    def box(z):
        p = _reflect101_pad(z, r)
        acc = 0.0
        for i in range(block_size):
            acc = acc + p[..., i:i + h, :]
        out = 0.0
        for j in range(block_size):
            out = out + acc[..., :, j:j + w]
        return out

    a = box(dx * dx) * 0.5
    b = box(dx * dy)
    c = box(dy * dy) * 0.5
    if low:
        return ((a + c) - torch.sqrt((a - c) * (a - c) + b * b)).float()
    q = torch.sqrt(((a - c) * (a - c) + b * b).double()).float()
    return (a + c) - q


def _local_max_3x3(eig):
    m = torch.nn.functional.pad(eig, (0, 0, 1, 1), value=float("-inf"))
    m = torch.maximum(torch.maximum(m[..., :-2, :], m[..., 2:, :]),
                      m[..., 1:-1, :])
    m2 = torch.nn.functional.pad(m, (1, 1), value=float("-inf"))
    return torch.maximum(torch.maximum(m2[..., :-2], m2[..., 2:]),
                         m2[..., 1:-1])


def keypoints(img, gftt: dict, orb: dict, n_cand: int, capacity: int,
              low: bool = False) -> np.ndarray:
    """One (H, W) uint8 image -> (n, 3) float32 [x, y, response] in
    acceptance order: local maxima of the response above quality_level
    of its maximum, the n_cand strongest (ties to the lower flat index),
    kept greedily when no kept corner lies closer than min_distance, at
    most max_features of them, then those inside ORB's border."""
    h, w = img.shape
    eig = gftt_response(img[None], gftt["block_size"], low)[0]
    thr = eig.amax() * torch.tensor(gftt["quality_level"],
                                    dtype=torch.float32, device=eig.device)
    z = torch.where(eig > thr, eig, 0.0)
    mask = (z != 0.0) & (z == _local_max_3x3(z))
    mask[0, :] = False
    mask[-1, :] = False
    mask[:, 0] = False
    mask[:, -1] = False
    flat = torch.where(mask, eig, float("-inf")).reshape(-1).cpu().numpy()
    order = np.argsort(-flat, kind="stable")[:n_cand]
    order = order[np.isfinite(flat[order])]
    xs = (order % w).astype(np.float32)
    ys = (order // w).astype(np.float32)
    md2 = np.float32(gftt["min_distance"]) * np.float32(gftt["min_distance"])
    kx = np.empty(len(order), np.float32)
    ky = np.empty(len(order), np.float32)
    kept = []
    for i in range(len(order)):
        n = len(kept)
        if n:
            ddx = kx[:n] - xs[i]
            ddy = ky[:n] - ys[i]
            if np.any(ddx * ddx + ddy * ddy < md2):
                continue
        kx[n], ky[n] = xs[i], ys[i]
        kept.append(i)
    kept = np.array(kept[:min(gftt["max_features"], capacity)], np.int64)
    x, y = xs[kept], ys[kept]
    e = orb["edge_threshold"]
    inside = (x >= e) & (x < w - e) & (y >= e) & (y < h - e)
    return np.stack([x, y, flat[order[kept]]], axis=1)[inside]


# ---------------------------------------------------------------------------
# ORB descriptors at constant angle (kernels/orb.py)
# ---------------------------------------------------------------------------

def _const_angle_offsets(angle_deg: float):
    pat = np.asarray(np.load(os.path.join(_HERE, "orb_pattern.npy")),
                     np.float32)
    ca = np.cos(angle_deg * np.pi / 180.0)
    sb = np.sin(angle_deg * np.pi / 180.0)
    dxs = np.round(pat[:, 0] * ca - pat[:, 1] * sb).astype(np.int32)
    dys = np.round(pat[:, 0] * sb + pat[:, 1] * ca).astype(np.int32)
    R = int(max(-dxs.min(), dxs.max(), -dys.min(), dys.max()))
    return dxs, dys, R


def orb_blur(img, low: bool = False):
    """7x7 sigma-2 Gaussian blur with reflect-101 borders (vertical taps,
    then horizontal), rounded half up to uint8."""
    xs = np.arange(7) - 3
    k = np.exp(-(xs.astype(np.float64) ** 2) / (2.0 * 2.0 ** 2))
    dt = torch.bfloat16 if low else torch.float32
    k = torch.as_tensor((k / k.sum()).astype(np.float32),
                        device=img.device).to(dt)
    h, w = img.shape[-2:]
    p = _reflect101_pad(img.to(dt), 3)
    v = 0.0
    for i in range(7):
        v = v + k[i] * p[..., i:i + h, :]
    out = 0.0
    for j in range(7):
        out = out + k[j] * v[..., :, j:j + w]
    return torch.clamp(torch.floor(out.float() + 0.5), 0, 255) \
        .to(torch.uint8)


def descriptors(img, kpts: np.ndarray, angle_deg: float = -1.0,
                low: bool = False) -> np.ndarray:
    """(H, W) uint8 image and (n, 3) keypoints -> (n, 32) uint8: the 256
    tests t0 < t1 of the blurred image, packed LSB first."""
    blurred = orb_blur(img, low).cpu().numpy().astype(np.int16)
    h, w = blurred.shape
    dxs, dys, R = _const_angle_offsets(angle_deg)
    pad = np.pad(blurred, R)
    cx = np.clip(np.round(kpts[:, 0]).astype(np.int64), 0, w - 1)
    cy = np.clip(np.round(kpts[:, 1]).astype(np.int64), 0, h - 1)
    s = pad[cy[:, None] + R + dys[None], cx[:, None] + R + dxs[None]]
    bits = (s[:, 0::2] < s[:, 1::2]).astype(np.uint8)
    return np.packbits(bits.reshape(-1, 32, 8), axis=-1,
                       bitorder="little")[..., 0]


# ---------------------------------------------------------------------------
# the 3D lift (vo/fused.py) and the whole front end
# ---------------------------------------------------------------------------

def lift(kpts: np.ndarray, disp: torch.Tensor, P0, P1,
         low: bool = False) -> np.ndarray:
    """(n, 3) keypoints and the (H, W) x16 disparity -> (n, 3) robot-frame
    points, NaN where the disparity is invalid (Stereo.cpp:53-117)."""
    dt = torch.bfloat16 if low else torch.float32
    dev = disp.device
    f = dict(dtype=dt, device=dev)
    fx, cx_l, cy_l = P0[0, 0], P0[0, 2], P0[1, 2]
    c_rl = torch.tensor(P1[0, 2] - P0[0, 2], **f)
    wx_n = torch.tensor(P0[0, 3] / P0[0, 0] - P1[0, 3] / P1[0, 0], **f)
    wy_n = torch.tensor(P0[0, 3] / P0[1, 1] - P1[0, 3] / P1[1, 1], **f)
    k = torch.as_tensor(kpts[:, :2], device=dev).to(dt)
    xi = torch.as_tensor(kpts[:, 0], device=dev).long()
    yi = torch.as_tensor(kpts[:, 1], device=dev).long()
    d = torch.clamp(disp[yi, xi].to(dt) / 16.0, min=0.0)
    denom = d + c_rl
    Wx = wx_n / denom
    Wy = wy_n / denom
    px = (k[:, 0] - torch.tensor(cx_l, **f)) * Wx
    py = (k[:, 1] - torch.tensor(cy_l, **f)) * Wy
    pz = torch.tensor(fx, **f) * Wx
    pts = torch.stack([px, py, pz], dim=-1)
    lt = torch.as_tensor(LOCAL_TRANSFORM, device=dev).to(dt)
    pts = pts @ lt[:3, :3].T + lt[:3, 3]
    ok = (d > 0.0) & torch.isfinite(pts).all(dim=-1)
    return torch.where(ok[:, None], pts, float("nan")).float().cpu().numpy()


def frontend(left, right, cfg: dict, calib: dict,
             low: bool = False) -> list[dict]:
    """(K, H, W) uint8 pairs on one device -> per frame the keypoints,
    descriptors, 3D points and decimated disparity that the timed path
    hands the map, as `cfg` (a configuration file's `pipeline`) states."""
    depth = cfg["depth"]
    if depth == "sgbm":
        disp = sgbm(left, right, cfg["sgbm"], low)
    else:
        disp = stereo_bm(left, right, cfg["bm"], low)
    dec = cfg["disp_decimation"]
    _, H, W = left.shape
    out = []
    for i in range(left.shape[0]):
        kp = keypoints(left[i], cfg["gftt"], cfg["orb"], cfg["n_cand"],
                       cfg["capacity"], low)
        out.append(dict(
            kpts=kp,
            desc=descriptors(left[i], kp, low=low),
            pts3d=lift(kp, disp[i], calib["P0"], calib["P1"], low),
            disp_dec=disp[i, :H // dec * dec:dec, :W // dec * dec:dec]
            .cpu().numpy()))
    return out
