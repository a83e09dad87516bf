"""What decides `correct`: the timed path's own outputs against the plain
reference (slambench/reference/frontend.py) and against the log's ground
truth.

During the window the wrapped `_consume` keeps, for every chunk it
completes, the per-frame results (pose, lost flag, inliers, keypoint
count) and the features the pipeline handed the Mapper for its map nodes
(keypoints, descriptors, 3D points, decimated disparity).  Once the
window has closed and the program's state is freed, a sample of those
node frames, drawn from the seed, goes through the reference on the same
images, and every frame's pose is held to the ground truth.

Each number has a limit in the configuration file, as [op, limit] with
op "<=" or ">=":
  disp_px        decimated disparity values that differ from the
                 reference's (StereoBM with its left-right check, or SGBM)
  kpt_diff       keypoints that differ in x, y or response, plus the
                 difference in their count (GFTT, NMS, ORB border)
  desc_bits      descriptor bits that differ at the common keypoints
  pts3d_err      the largest 3D point error at the common keypoints, in
                 units of max(|reference point|, 1 m); NaN against a
                 number counts as 1
  lost           frames the VO step reported lost (each replay's first
                 frame aside)
  inliers_min    the least median of PnP inliers over the replays
  ate_m          the worst replay's absolute trajectory error, over the
                 replay's frames (a replay stopped by the window's close
                 counts its completed frames, one chunk or more)
  t_err_pct      the worst KITTI translation error of a replay that
                 covered a 100 m segment
  graph_ate_m    the worst replay's error of the Mapper graph's node poses
  loop_closures  loop-closure links in the Mapper graphs: the forward
                 drive revisits no place, so each is false
"""

from __future__ import annotations

import numpy as np
import torch

from . import kitti
from .reference import frontend as ref

OUT_KEYS = ("pose", "lost", "n_inliers", "n_kpts")
FEAT_KEYS = ("kpts", "pts3d", "desc", "disp_dec", "n_kpts")


def capture(pending) -> tuple:
    """(start, n, outs, feats) of a consumed chunk, as host copies."""
    outs = {k: pending["outs"][k].numpy().copy() for k in OUT_KEYS}
    feats = {k: pending["feats"][k].numpy().copy() for k in FEAT_KEYS}
    return int(pending["start"]), int(pending["n"]), outs, feats


def _frames(replay):
    """Per-frame arrays of one replay, in order."""
    outs = [c[2] for c in replay.chunks]
    n = [c[1] for c in replay.chunks]
    return {k: np.concatenate([o[k][:m] for o, m in zip(outs, n)])
            for k in OUT_KEYS}


def trajectory_numbers(replays, gt: np.ndarray, chunk: int) -> dict:
    """The pose numbers over every replay that completed a chunk."""
    lost, inl, ates, terrs, gates, lcs = 0, [], [], [], [], 0
    for rp in replays:
        if not rp.chunks:
            continue
        fr = _frames(rp)
        n = len(fr["pose"])
        lost += int(fr["lost"][1:].sum())
        if n > 1:
            inl.append(float(np.median(fr["n_inliers"][1:])))
        if n >= chunk:
            ates.append(kitti.ate(gt[:n], fr["pose"]))
        t_err = kitti.segment_errors(gt[:n], fr["pose"])[0]
        if not np.isnan(t_err):
            terrs.append(t_err)
        ids = [i for i in sorted(rp.graph_poses) if i <= n]
        if ids:
            gates.append(kitti.ate(gt[[i - 1 for i in ids]],
                                   np.stack([rp.graph_poses[i]
                                             for i in ids])))
        lcs += rp.loop_closures
    nan = float("nan")
    return dict(lost=lost, inliers_min=min(inl) if inl else nan,
                ate_m=max(ates) if ates else nan,
                t_err_pct=max(terrs) if terrs else nan,
                graph_ate_m=max(gates) if gates else nan,
                loop_closures=lcs)


def node_frames(replays, chunk: int, map_update: int) -> list:
    """(frame index, feats, slot) of every map node a consumed chunk
    carried."""
    offsets = list(range(map_update - 1, chunk, map_update))
    out = []
    for rp in replays:
        for start, n, _, feats in rp.chunks:
            for slot, off in enumerate(offsets):
                if off < n:
                    out.append((start + off, feats, slot))
    return out


def program_frame(feats: dict, slot: int) -> dict:
    """A map node's features as the pipeline handed them over, in the
    reference's form."""
    n = int(feats["n_kpts"][slot])
    return dict(kpts=feats["kpts"][slot][:n], desc=feats["desc"][slot][:n],
                pts3d=feats["pts3d"][slot][:n],
                disp_dec=feats["disp_dec"][slot])


def compare(got: dict, want: dict) -> dict:
    """The front-end numbers of one node frame: `got` against the
    reference's `want`."""
    m = min(len(got["kpts"]), len(want["kpts"]))
    kpt_diff = abs(len(got["kpts"]) - len(want["kpts"])) + \
        int(np.sum(np.any(got["kpts"][:m] != want["kpts"][:m], axis=1)))
    x = np.bitwise_xor(got["desc"][:m], want["desc"][:m])
    a = got["pts3d"][:m].astype(np.float64)
    b = want["pts3d"][:m].astype(np.float64)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    err = np.where(nan_a | nan_b, np.where(nan_a == nan_b, 0.0, 1.0), err)
    return dict(disp_px=int(np.sum(got["disp_dec"] != want["disp_dec"])),
                kpt_diff=kpt_diff, desc_bits=int(np.unpackbits(x).sum()),
                pts3d_err=float(err.max()) if err.size else 0.0)


def reference_frontend(left, right, pipeline: dict, calib_path: str,
                       device, low: bool = False) -> list:
    """The reference over (K, H, W) uint8 host images."""
    lt = torch.as_tensor(left, device=device)
    rt = torch.as_tensor(right, device=device)
    with torch.no_grad():
        return ref.frontend(lt, rt, pipeline, ref.read_calib(calib_path),
                            low)


def frontend_numbers(pairs: list) -> dict:
    """The front-end numbers over (got, want) frame pairs: counts summed,
    the point error the worst."""
    out = dict(disp_px=0, kpt_diff=0, desc_bits=0, pts3d_err=0.0)
    for got, want in pairs:
        for k, v in compare(got, want).items():
            out[k] = out[k] + v if k != "pts3d_err" else max(out[k], v)
    return out


def stream_numbers(stream, rng: np.random.Generator) -> dict:
    """Every number of one stream once its window has closed."""
    pl = stream.config["pipeline"]
    nums = trajectory_numbers(stream.replays, stream.gt, pl["chunk"])
    nodes = node_frames(stream.replays, pl["chunk"], pl["map_update"])
    k = min(stream.traffic["check_frames"], len(nodes))
    pick = sorted(rng.choice(len(nodes), size=k, replace=False)) if k else []
    idx = [nodes[i][0] for i in pick]
    mine = reference_frontend(stream.left[idx], stream.right[idx], pl,
                              stream.calib, stream.device) if idx else []
    nums.update(frontend_numbers([
        (program_frame(nodes[i][1], nodes[i][2]), r)
        for i, r in zip(pick, mine)]))
    nums["frames_checked"] = len(idx)
    return nums


WORST = {"<=": max, ">=": min}


def merge(per_stream: list, limits: dict) -> dict:
    """The worst of each limited number over the streams; a number that
    is NaN everywhere stays NaN."""
    out = {}
    for name, (op, _) in limits.items():
        vals = [s[name] for s in per_stream
                if not (isinstance(s[name], float) and np.isnan(s[name]))]
        out[name] = WORST[op](vals) if vals else float("nan")
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [[name, value, op, limit], ...]); a NaN fails."""
    rows, ok = [], True
    for name, (op, lim) in limits.items():
        v = numbers[name]
        good = (v <= lim) if op == "<=" else (v >= lim)
        ok &= bool(good)       # NaN compares False
        rows.append([name, v, op, lim])
    return ok, rows
