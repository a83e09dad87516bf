"""GFTT (Shi-Tomasi min-eigenvalue) corners: plain PyTorch versions, the
dispatcher to the hand-written CUDA kernel (csrc/gftt.cu), the two-stage
top-k and the greedy min-distance NMS.

Counterpart of tpuslam/kernels/gftt.py (`gftt_response`, `local_max_3x3`,
`_two_stage_top_k`, `gftt_candidates`, `select_from_candidates_device`)
and of the Pallas kernel gftt.py:gftt_response_dil_pallas.  Every torch
function takes a leading frame axis (B, H, W).  The per-frame path's host
NMS (`select_from_candidates`, `select_keypoints`, `_grid_suppress`) is
numpy, copied from tpuslam/kernels/gftt.py.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

NEG_INF = float("-inf")


def _reflect101_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of the last two axes."""
    top = x[..., 1:r + 1, :].flip(-2)
    bot = x[..., -r - 1:-1, :].flip(-2)
    x = torch.cat([top, x, bot], dim=-2)
    left = x[..., :, 1:r + 1].flip(-1)
    right = x[..., :, -r - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _sep_filter(x, kcol, krow):
    """Separable 3-tap filter with reflect-101 borders (float32), in
    tpuslam's accumulation order."""
    p = _reflect101_pad(x, 1)
    v = kcol[0] * p[..., :-2, :] + kcol[1] * p[..., 1:-1, :] + \
        kcol[2] * p[..., 2:, :]
    return krow[0] * v[..., :, :-2] + krow[1] * v[..., :, 1:-1] + \
        krow[2] * v[..., :, 2:]


def gftt_response(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Min-eigenvalue response of (..., H, W) uint8, float32, matching
    cv::cornerMinEigenVal (ksize 3 Sobel, unnormalized box, 8U scale)."""
    h, w = img.shape[-2:]
    x = img.float()
    scale = 1.0 / ((1 << 2) * block_size * 255.0)
    smooth = (1.0, 2.0, 1.0)
    deriv = (-1.0, 0.0, 1.0)
    dx = _sep_filter(x, smooth, deriv) * scale
    dy = _sep_filter(x, deriv, smooth) * scale
    r = block_size // 2

    def box(z):
        # reflect-101 of the PRODUCT image (the cv2 box-filter quirk)
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
    # the square root correctly rounded on every device, as the card's and
    # K2's (sqrt_rn): the CPU's vectorised f32 sqrt is not, and a sqrt
    # taken in f64 and rounded to f32 is
    q = torch.sqrt(((a - c) * (a - c) + b * b).double()).float()
    return (a + c) - q


def local_max_3x3(eig: torch.Tensor) -> torch.Tensor:
    """3x3 dilation with -inf outside the image (cv::dilate as used by
    goodFeaturesToTrack)."""
    m = torch.nn.functional.pad(eig, (0, 0, 1, 1), value=NEG_INF)
    m = torch.maximum(torch.maximum(m[..., :-2, :], m[..., 2:, :]),
                      m[..., 1:-1, :])
    m2 = torch.nn.functional.pad(m, (1, 1), value=NEG_INF)
    return torch.maximum(torch.maximum(m2[..., :-2], m2[..., 2:]),
                         m2[..., 1:-1])


def gftt_response_dil_plain(img: torch.Tensor):
    """Plain version of kernel K2: (B, H, W) uint8 ->
    (eig, dil) float32 with dil the raw 3x3 dilation of eig."""
    _cuda.PLAIN_CALLS["gftt"] += 1
    eig = gftt_response(img, 3)
    return eig, local_max_3x3(eig)


def gftt_response_dil_cuda(img: torch.Tensor):
    """Kernel K2 (csrc/gftt.cu): same contract as gftt_response_dil_plain,
    bit-equal to it."""
    _cuda.expect(img, "img", torch.uint8, 3)
    B, H, W = img.shape
    if H < 2 or W < 2:
        raise ValueError("image smaller than 2x2")
    eig = torch.empty(img.shape, dtype=torch.float32, device=img.device)
    dil = torch.empty_like(eig)
    with torch.cuda.device(img.device):
        _cuda.launch("gftt", img, eig, dil, B, H, W)
    return eig, dil


def k2_refusal(block_size: int) -> str | None:
    """Why kernel K2 cannot compute the response at `block_size`, or None
    where it can: csrc/gftt.cu is built for 3x3 blocks."""
    if block_size != 3:
        return f"block_size {block_size}: csrc/gftt.cu is built for block 3"
    return None


def gftt_response_auto(img: torch.Tensor, block_size: int = 3):
    """GFTT response of (B, H, W) uint8: kernel K2's first output on a
    CUDA tensor (bit-equal to gftt_response), the plain version (counted)
    on a CPU tensor.  A CUDA tensor at a block size K2 refuses raises
    ValueError: no plain version runs on the card here."""
    if img.is_cuda:
        refusal = k2_refusal(block_size)
        if refusal is not None:
            raise ValueError(f"gftt_response_auto on the card: {refusal}")
        return gftt_response_dil_cuda(img)[0]
    _cuda.PLAIN_CALLS["gftt"] += 1
    return gftt_response(img, block_size)


def gftt_kernel_attrs() -> dict:
    """Registers, shared bytes and local bytes per thread of K2's kernel
    on the current card, and its strips' output rows and columns and its
    warps (a strip each) per block."""
    out = _cuda.attributes("gftt", "tpuslam_gftt_attrs", 6)
    return dict(zip(("registers", "shared_bytes", "local_bytes",
                     "strip_rows", "strip_cols", "warps"), out))


def _two_stage_top_k(masked: torch.Tensor, k: int, k1: int = 256,
                     m: int = 256):
    """Exact-ordered top-k of (B, n) flat response maps via m contiguous
    segments: per-segment top-k1, then top-k over the m*k1 survivors.
    Equal values resolve to the lower flat index (stable descending
    sorts), as lax.top_k does.  Indices at -inf slots are arbitrary."""
    B, n = masked.shape
    seg = -(-n // m)
    xp = torch.nn.functional.pad(masked, (0, seg * m - n), value=NEG_INF)
    xp = xp.view(B, m, seg)
    k1 = min(k1, seg)
    v1, i1 = torch.sort(xp, dim=-1, descending=True, stable=True)
    v1, i1 = v1[..., :k1], i1[..., :k1]
    gidx = i1 + (torch.arange(m, device=masked.device) * seg)[:, None]
    v2, i2 = torch.sort(v1.reshape(B, -1), dim=-1, descending=True,
                        stable=True)
    v2, i2 = v2[:, :k], i2[:, :k]
    return v2, gidx.reshape(B, -1).gather(1, i2)


def gftt_candidates(img: torch.Tensor, quality_level: float,
                    block_size: int = 3, max_candidates: int = 4096):
    """Response + threshold + 3x3 local max + top-k over (B, H, W) uint8.

    Returns (vals (B, K), flat_idx (B, K), max_response (B,),
    n_candidates (B,)).  A CUDA tensor runs kernel K2 and uses the
    raw-dilation mask; the plain path thresholds first.  The two masks
    agree: above the threshold, a strictly larger neighbour is itself
    above the threshold, so (z != 0) & (z == dil(z)) equals
    (eig > thr) & (eig == dil(eig)).  A CUDA tensor with another block
    size than K2's takes the plain path on the card (k2_refusal)."""
    B = img.shape[0]
    qual = torch.tensor(quality_level, dtype=torch.float32)
    if _cuda.on_kernel(img, k2_refusal(block_size)):
        eig, dil = gftt_response_dil_cuda(img)
        maxv = eig.amax(dim=(1, 2))
        thr = maxv * qual.to(img.device)
        mask = (eig > thr[:, None, None]) & (eig == dil)
    else:
        _cuda.PLAIN_CALLS["gftt"] += 1
        eig = gftt_response(img, block_size)
        maxv = eig.amax(dim=(1, 2))
        thr = maxv * qual
        z = torch.where(eig > thr[:, None, None], eig, 0.0)
        mask = (z != 0.0) & (z == local_max_3x3(z))
    mask[:, 0, :] = False
    mask[:, -1, :] = False
    mask[:, :, 0] = False
    mask[:, :, -1] = False
    masked = torch.where(mask, eig, NEG_INF).reshape(B, -1)
    vals, idx = _two_stage_top_k(masked, max_candidates)
    return vals, idx, maxv, mask.sum(dim=(1, 2))


def select_from_candidates_device(vals: torch.Tensor, flat_idx: torch.Tensor,
                                  width: int, min_distance: float,
                                  max_features: int = 1500,
                                  capacity: int = 1536):
    """Greedy min-distance suppression over (B, n) candidates already in
    descending-response order: candidate i is kept iff no earlier KEPT
    candidate lies within min_distance (GFTT.cpp:78-141).

    Blocks of 256 candidates are decided in order; inside a block the
    greedy set is the fixpoint of parallel status rounds.  The round loop
    checks convergence on the host every few rounds (a later kernel
    candidate, ROADMAP).  Returns (kpts (B, capacity, 3) [x, y, response]
    in acceptance order, valid (B, capacity), n_accepted (B,))."""
    B, n = vals.shape
    dev = vals.device
    finite = vals > -3e38
    xs = (flat_idx % width).float()
    ys = (flat_idx // width).float()
    md = torch.tensor(min_distance, dtype=torch.float32)
    md2 = (md * md).to(dev)

    BS = 256 if n % 256 == 0 else n
    in_full = torch.zeros((B, n), dtype=torch.bool, device=dev)
    col = torch.arange(n, device=dev)
    lower = torch.tril(torch.ones(BS, BS, dtype=torch.bool, device=dev), -1)
    for g0 in range(0, n, BS):
        xb, yb, finb = xs[:, g0:g0 + BS], ys[:, g0:g0 + BS], \
            finite[:, g0:g0 + BS]
        dxr = xb[:, :, None] - xs[:, None, :]
        dyr = yb[:, :, None] - ys[:, None, :]
        near_row = ((dxr * dxr + dyr * dyr < md2) &
                    (col[None, None, :] < (g0 + col[:BS])[None, :, None]) &
                    finite[:, None, :] & finb[:, :, None])
        sup_prev = (near_row & in_full[:, None, :]).any(dim=-1)
        dxb = xb[:, :, None] - xb[:, None, :]
        dyb = yb[:, :, None] - yb[:, None, :]
        nbb = ((dxb * dxb + dyb * dyb < md2) & lower[None] &
               finb[:, None, :] & finb[:, :, None])
        in_m = torch.zeros((B, BS), dtype=torch.bool, device=dev)
        out_m = sup_prev
        rounds = 0
        while rounds < BS:
            for _ in range(4):
                undecided = finb & ~in_m & ~out_m
                some_in = (nbb & in_m[:, None, :]).any(dim=-1)
                any_not_out = (nbb & ~out_m[:, None, :]).any(dim=-1)
                in_m = in_m | (undecided & ~any_not_out)
                out_m = out_m | (undecided & some_in)
            rounds += 4
            if not bool((finb & ~in_m & ~out_m).any()):
                break
        in_full[:, g0:g0 + BS] = in_m

    # compact accepted candidates in order, cap at max_features
    order = torch.argsort((~in_full).to(torch.uint8), dim=1, stable=True)
    if n < capacity:
        order = torch.nn.functional.pad(order, (0, capacity - n))
    order = order[:, :capacity]
    n_acc = torch.clamp(in_full.sum(dim=1), max=max_features)
    valid = torch.arange(capacity, device=dev)[None, :] < n_acc[:, None]
    kpts = torch.stack([xs.gather(1, order), ys.gather(1, order),
                        vals.gather(1, order)], dim=-1)
    kpts = torch.where(valid[..., None], kpts, 0.0)
    return kpts, valid, n_acc


# --- the per-frame path's host NMS (copied from tpuslam/kernels/gftt.py) ---

def select_from_candidates(vals: np.ndarray, flat_idx: np.ndarray,
                           width: int,
                           max_features: int = 1500,
                           min_distance: float = 7.0) -> np.ndarray:
    """Host half of the device-candidate path: identical sort order and
    grid min-distance suppression as select_keypoints (the candidates
    arrive already thresholded, local-max'd and sorted)."""
    keep = np.isfinite(vals)
    vals = vals[keep]
    flat_idx = flat_idx[keep]
    ys = (flat_idx // width).astype(np.int64)
    xs = (flat_idx % width).astype(np.int64)
    return _grid_suppress(xs, ys, vals, width, max_features, min_distance)


def select_keypoints(eig: np.ndarray,
                     max_features: int = 1500,
                     quality_level: float = 0.01,
                     min_distance: float = 7.0,
                     use_local_max: bool = True,
                     max_value: float | None = None) -> np.ndarray:
    """Host-side candidate selection.

    Returns (N, 3) float32 array of (x, y, response), N <= max_features.

    With use_local_max=True this reproduces cv::goodFeaturesToTrack
    (threshold -> 3x3 dilation non-max -> sort -> grid suppression); with
    False it reproduces the reference's FPGA path `generateKeypoints2`
    (GFTT.cpp:41-170) operating on the raw thresholded map.

    `max_value` overrides the map maximum (the FPGA per-frame max-eigenvalue
    register semantics, FPGA.cpp:291-297).
    """
    eig = np.asarray(eig)
    h, w = eig.shape
    maxv = float(eig.max()) if max_value is None else float(max_value)
    thr = maxv * quality_level

    if use_local_max:
        # threshold-to-zero then 3x3 local max, interior only (1..size-2)
        z = np.where(eig > thr, eig, 0.0)
        from scipy.ndimage import maximum_filter
        dil = maximum_filter(z, size=3, mode="constant", cval=0.0)
        mask = (z != 0) & (z == dil)
        mask[0, :] = mask[-1, :] = False
        mask[:, 0] = mask[:, -1] = False
        ys, xs = np.nonzero(mask)
        vals = z[ys, xs]
    else:
        # generateKeypoints2: plain threshold (>=), interior only
        mask = eig >= thr
        mask[0, :] = mask[-1, :] = False
        mask[:, 0] = mask[:, -1] = False
        ys, xs = np.nonzero(mask)
        vals = eig[ys, xs]

    # descending sort; ties resolved by row-major position (the reference's
    # greaterThanPtr pointer comparison, GFTT.cpp:31-39)
    flat = ys.astype(np.int64) * w + xs
    order = np.lexsort((flat, -vals))
    ys, xs, vals = ys[order], xs[order], vals[order]
    return _grid_suppress(xs, ys, vals, w, max_features, min_distance)


def _grid_suppress(xs, ys, vals, w: int, max_features: int,
                   min_distance: float) -> np.ndarray:
    """Grid-bucket min-distance suppression over candidates already in
    descending-response order (GFTT.cpp:78-141)."""
    if min_distance < 1:
        out = [(float(x), float(y), float(v))
               for x, y, v in zip(xs[:max_features], ys[:max_features],
                                  vals[:max_features])]
        return np.array(out, dtype=np.float32).reshape(-1, 3)

    cell = int(round(min_distance))
    gw = (w + cell - 1) // cell
    gh = (int(ys.max()) // cell + 1) if len(ys) else 1
    grid: list[list[tuple[float, float]]] = [[] for _ in range(gw * gh)]
    md2 = min_distance * min_distance
    out = []
    for x, y, v in zip(xs, ys, vals):
        xc, yc = int(x) // cell, int(y) // cell
        good = True
        for yy in range(max(0, yc - 1), min(gh - 1, yc + 1) + 1):
            for xx in range(max(0, xc - 1), min(gw - 1, xc + 1) + 1):
                for (px, py) in grid[yy * gw + xx]:
                    dx = float(x) - px
                    dy = float(y) - py
                    if dx * dx + dy * dy < md2:
                        good = False
                        break
                if not good:
                    break
            if not good:
                break
        if good:
            grid[yc * gw + xc].append((float(x), float(y)))
            out.append((float(x), float(y), float(v)))
            if len(out) == max_features:
                break
    return np.array(out, dtype=np.float32).reshape(-1, 3)

