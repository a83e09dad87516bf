"""Chunked driver for the fused VO (vo/fused.py), in PyTorch.

Counterpart of tpuslam/runtime/fast_pipeline.py: frames go to the device
in chunks; while the host unpacks chunk i's results and feeds them to the
Mapper, chunk i+1 is already queued on the device.  Per chunk there is one
upload of the images (none for chunks staged by `stage_chunks`) and one
download of the small per-frame results, copied into pinned host memory
without blocking and waited for with an event when the chunk is
collected.  With a Mapper, the chunk's dictionary update
(mapping/chunk_dict.py) is queued on the device right after the VO chunk,
and the Mapper's torch work runs on the pipeline's device.  `run_ingest`
reads the frames from files through the native prefetch ring
(io/native_loader.py) and uploads them from pinned host buffers on a copy
stream while earlier chunks compute.

Not ported: the XLA compile cache and AOT artifacts, which exist only for
XLA.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel
from ..vo.frame import Frame
from ..vo.fused import make_fused_chunk_fn, FusedShapes
from ..vo.odometry import OdomInfo
from . import perf

MODEL_POINTS = 6      # EPnP minimal sample of the fused RANSAC


def _put_or_raise(q, item, t, err) -> None:
    """q.put that cannot deadlock against a dead consumer: poll with a
    timeout and surface the consumer's error on the producer."""
    while True:
        if err:
            raise err[0]
        try:
            q.put(item, timeout=0.2)
            return
        except queue.Full:
            if not t.is_alive():
                raise err[0] if err else RuntimeError(
                    "pipeline consumer thread died without reporting")


def _as_u8(img) -> torch.Tensor:
    """A frame as a uint8 tensor (numpy frames are copied: decoded images
    are often read-only)."""
    if isinstance(img, torch.Tensor):
        return img
    return torch.from_numpy(np.array(img, np.uint8))


class FastSlamPipeline:
    """Fused-VO chunk driver on one torch device.

    Runs on the card unless the caller asks for the CPU (device="cpu").
    `draws_fn(frame_index) -> (n_hyp, 6) array` supplies each frame's
    RANSAC uniforms (tests pass tpuslam's own draws); by default they come
    from a torch.Generator on the device seeded with `seed`."""

    def __init__(self, camera: StereoCameraModel, cfg: SlamConfig,
                 chunk: int = 40, capacity: int = 1536, device="cuda",
                 seed: int = 0, draws_fn=None, device_dict: bool = True):
        mu = cfg.mapper.map_update
        if chunk % mu:
            chunk += mu - chunk % mu     # align chunks to node cadence
        self.camera = camera
        self.cfg = cfg
        self.chunk = chunk
        self.capacity = capacity
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.seed = seed
        self.draws_fn = draws_fn
        self.device_dict = device_dict
        self._replay = -1
        shapes = FusedShapes(chunk=chunk, capacity=capacity)
        self._init_carry, self._step, self._offsets = make_fused_chunk_fn(
            camera, cfg, shapes, device=self.device)
        self.reset()

    def reset(self):
        # the recorder's chunk ids are (replay, first frame)
        self._replay += 1
        self.carry = self._init_carry()
        self._frames = 0
        self._prev_stamp = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self._dict_driver = None

    def _attach_mapper(self, mapper) -> None:
        """Run the mapper's torch work on this device, and start the
        per-run device dictionary (mapping/chunk_dict.py): one update per
        chunk, queued right after the VO chunk on its device features."""
        self._dict_driver = None
        if mapper is None:
            return
        mapper.device = self.device
        # the per-chunk device dictionary is the single-process
        # dictionary's: a mapper that searches its own (PartitionedMapper,
        # rank-sharded) opts out with device_dict_ok = False
        if not self.device_dict or \
                not getattr(mapper, "device_dict_ok", False):
            return
        from ..mapping.chunk_dict import ChunkDictDriver
        driver = ChunkDictDriver(self.cfg.mapper.dict_nndr,
                                 self.cfg.mapper.max_features_per_node,
                                 device=self.device)
        if mapper.vwd._count:
            driver.seed(mapper.vwd)
        self._dict_driver = driver

    # -- device side -------------------------------------------------------
    def stage_chunks(self, items: list[dict]) -> list[tuple]:
        """Upload a sequence to the device as padded (B, H, W) chunks.
        Each item holds `left` and `right` (numpy or torch uint8) and a
        `stamp`.  Returns (lefts, rights, stamps, n) tuples for
        `dispatch` / `run_staged`."""
        B = self.chunk
        H, W = self.camera.height, self.camera.width
        staged = []
        for lo in range(0, len(items), B):
            batch = items[lo:lo + B]
            n = len(batch)
            lr = []
            for key in ("left", "right"):
                buf = torch.zeros((B, H, W), dtype=torch.uint8,
                                  device=self.device)
                buf[:n] = torch.stack([_as_u8(b[key])
                                       for b in batch]).to(self.device)
                lr.append(buf)
            staged.append((lr[0], lr[1],
                           np.array([b["stamp"] for b in batch]), n))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return staged

    def _draws(self, n: int) -> torch.Tensor:
        B = self.chunk
        n_hyp = self.cfg.pnp.iterations_count
        if self.draws_fn is None:
            return torch.rand((B, n_hyp, MODEL_POINTS), generator=self._gen,
                              device=self.device)
        # frame i of the chunk sees carry frames == self._frames + i;
        # padding frames revert the carry, so their draws are unused
        d = np.stack([np.asarray(self.draws_fn(self._frames + min(i, n - 1)),
                                 np.float32) for i in range(B)])
        return torch.as_tensor(d, device=self.device)

    def dispatch(self, lefts, rights, stamps, n_active: int):
        """Queue one chunk on the device (no host sync).  `lefts`/`rights`
        are host arrays of the active frames or staged (B, H, W) device
        tensors.  Returns a pending handle for collect()."""
        B = self.chunk
        n = int(n_active)
        if not 0 < n <= B:
            raise ValueError(f"n_active={n} outside 1..{B}")

        with perf.span("pipe.dispatch", chunk=(self._replay, self._frames),
                       frames=n):
            H, W = self.camera.height, self.camera.width
            if isinstance(lefts, torch.Tensor) and lefts.shape == (B, H, W) \
                    and lefts.device == self.device:
                lb, rb = lefts, rights
            else:
                lb = torch.zeros((B, H, W), dtype=torch.uint8,
                                 device=self.device)
                rb = torch.zeros_like(lb)
                lb[:n] = _as_u8(lefts[:n]).to(self.device)
                rb[:n] = _as_u8(rights[:n]).to(self.device)
            st = np.asarray(stamps, np.float64)
            dts = np.zeros((B,), np.float32)
            prev = self._prev_stamp
            for i in range(n):
                dts[i] = 0.0 if (self._frames + i == 0) \
                    else st[i] - (prev if i == 0 else st[i - 1])
            active = np.zeros((B,), bool)
            active[:n] = True

            self.carry, outs, feats = self._step(
                self.carry, lb, rb, torch.as_tensor(dts, device=self.device),
                torch.as_tensor(active, device=self.device), self._draws(n))
            dict_handle = None
            if self._dict_driver is not None:
                # queue the chunk's dictionary update on the VO chunk's device
                # outputs: VO_i -> dict_i -> VO_{i+1}
                dict_handle = self._dict_driver.dispatch(
                    feats["desc"], feats["kpts"][..., 2], feats["n_kpts"],
                    [o < n for o in self._offsets])
            # results go to pinned host memory without blocking; the event
            # marks when they have landed.  disp_dec is fetched here too, once:
            # nothing keeps it on the device
            with perf.span("pipe.fetch"):
                host = {k: {kk: vv.to("cpu", non_blocking=True)
                            for kk, vv in d.items()}
                        for k, d in (("outs", outs), ("feats", feats))}
                event = None
                if self.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
            start = self._frames
            self._frames += n
            self._prev_stamp = float(st[n - 1])
            perf.count("pipe.chunks")
            perf.count("pipe.frames", n)
            return dict(outs=host["outs"], feats=host["feats"], event=event,
                        n=n, start=start, stamps=st[:n], dts=dts[:n],
                        dict_handle=dict_handle, chunk=(self._replay, start))

    # -- host side -----------------------------------------------------------
    def collect(self, pending, gt_poses=None) -> list[tuple[OdomInfo,
                                                            Frame]]:
        """Wait for a dispatched chunk; return per-frame (OdomInfo, Frame).
        Full-node frames carry features and decimated disparity."""
        if pending["event"] is not None:
            with perf.span("consume.wait"):
                pending["event"].synchronize()
        with perf.span("consume.unpack"):
            outs = {k: v.numpy() for k, v in pending["outs"].items()}
            feats = {k: v.numpy() for k, v in pending["feats"].items()}
            n = pending["n"]
            start = pending["start"]
            off_to_slot = {o: j for j, o in enumerate(self._offsets)}

            results = []
            for i in range(n):
                info = OdomInfo(
                    pose=np.asarray(outs["pose"][i]),
                    lost=bool(outs["lost"][i]),
                    stamp=float(pending["stamps"][i]),
                    interval=float(pending["dts"][i]),
                    transform=(T.NULL.copy() if outs["lost"][i]
                               else np.asarray(outs["transform"][i])),
                    distance_travelled=float(outs["dist"][i]),
                    velocity=np.asarray(outs["vel"][i]),
                    covariance=np.asarray(outs["cov"][i], np.float64),
                    keyframe_added=bool(outs["keyframe"][i]),
                    num_inliers=int(outs["n_inliers"][i]),
                    num_matches=int(outs["n_matches"][i]),
                )
                gt = None if gt_poses is None else gt_poses[i]
                frame = Frame(stamp=info.stamp, frame_id=start + i, gt_pose=gt)
                slot = off_to_slot.get(i)
                if slot is not None:
                    nk = int(feats["n_kpts"][slot])
                    frame.kpts = feats["kpts"][slot][:nk]
                    frame.kpts3d = feats["pts3d"][slot][:nk]
                    frame.desc = feats["desc"][slot][:nk]
                    frame.disparity_dec = feats["disp_dec"][slot]
                results.append((info, frame))
            return results

    # -- end-to-end loops ----------------------------------------------------
    def run(self, items: list[dict], mapper=None) -> list[OdomInfo]:
        """Process `items` (dicts with left/right/stamp and optional
        ground_truth), dispatching chunk i+1 before unpacking chunk i;
        each frame then goes to `mapper` if one is given."""
        self._attach_mapper(mapper)

        def chunks():
            for lo in range(0, len(items), self.chunk):
                batch = items[lo:lo + self.chunk]
                yield (np.stack([np.asarray(b["left"]) for b in batch]),
                       np.stack([np.asarray(b["right"]) for b in batch]),
                       np.array([b["stamp"] for b in batch]), len(batch),
                       [b.get("ground_truth") for b in batch])

        return self._double_buffered(chunks(), mapper)

    def run_staged(self, staged: list[tuple], items: list[dict],
                   mapper=None, mapper_async: bool = False
                   ) -> list[OdomInfo]:
        """run() over chunks staged on the device (see stage_chunks): the
        loop holds no host-to-device image transfer.  With `mapper_async`
        the results are unpacked, and fed to `mapper`, on a consumer
        thread while the producer keeps dispatching chunks.  All mapper
        work (loop closure included) completes before this returns."""
        self._attach_mapper(mapper)

        def gts_of(i, n):
            return [b.get("ground_truth")
                    for b in items[i * self.chunk:i * self.chunk + n]]

        run = self._run_async if mapper_async else self._double_buffered
        return run(((lb, rb, stamps, n, gts_of(i, n))
                    for i, (lb, rb, stamps, n) in enumerate(staged)), mapper)

    def run_ingest(self, left_paths: list[str], right_paths: list[str],
                   stamps, mapper=None) -> list[OdomInfo]:
        """run_staged() over frames read from image files: the native
        decoder threads fill a ring of 2 * chunk + 8 banks ahead
        (io/native_loader.py); each frame is copied out of its bank into
        one of two rotating host chunk buffers per eye (pinned when the
        device is the card); every quarter chunk is uploaded on a copy
        stream as soon as it is decoded, so a chunk's upload overlaps the
        decode of its own tail and the compute of the chunk before; the
        chunk is dispatched once whole, and its results and the Mapper run
        on a consumer thread.  A partial last chunk goes to dispatch as
        host arrays.  Counterpart of tpuslam's run_ingest, the
        measured-loop analog of the reference's sensor-to-DDR DMA into
        the PL's double banks (xusb_main.c:91-212, FPGA.h:35-53)."""
        from ..io.native_loader import NativeStereoLoader
        with perf.span("pipe.open"):
            self._attach_mapper(mapper)
            loader = NativeStereoLoader(left_paths, right_paths,
                                        n_banks=2 * self.chunk + 8,
                                        n_threads=4)
        try:
            return self._run_async(
                self._ingest_chunks(loader, np.asarray(stamps, np.float64)),
                mapper)
        finally:
            with perf.span("ingest.close"):
                loader.close()

    def _ingest_chunks(self, loader, stamps):
        """(lefts, rights, stamps, n, None) of each chunk of `loader`'s
        frames: staged (B, H, W) device tensors for a whole chunk, host
        views of its buffer rows for a partial last one."""
        B = self.chunk
        H, W = self.camera.height, self.camera.width
        card = self.device.type == "cuda"
        n_total = len(loader)
        slab = max(1, B // 4)
        with perf.span("ingest.open"):
            bufs = [tuple(torch.empty((B, H, W), dtype=torch.uint8,
                                      pin_memory=card) for _ in range(2))
                    for _ in range(2)]
            views = [(lb.numpy(), rb.numpy()) for lb, rb in bufs]
            copy = torch.cuda.Stream(self.device) if card else None
        # the event after the last upload out of each buffer: the buffer
        # is refilled only once that upload has landed
        landed = [None, None]
        cur, chunk_idx, n_in, slabs = 0, 0, 0, []
        frames = iter(loader)
        try:
            while True:
                with perf.span("ingest.next"):
                    item = next(frames, None)
                if item is None:
                    break
                idx, left, right = item
                perf.count("ingest.frames")
                if left.shape != (H, W) or right.shape != (H, W):
                    raise ValueError(f"frame {idx}: {left.shape} and "
                                     f"{right.shape} images, the camera's "
                                     f"are {(H, W)}")
                if n_in == 0 and landed[cur] is not None:
                    with perf.span("ingest.landed"):
                        landed[cur].synchronize()
                    landed[cur] = None
                lb, rb = bufs[cur]
                with perf.span("ingest.copy"):
                    views[cur][0][n_in] = left        # out of the bank
                    views[cur][1][n_in] = right
                n_in += 1
                last = idx == n_total - 1
                if n_in % slab == 0 and n_in < B and not last:
                    s0 = n_in - slab
                    with perf.span("ingest.upload"):
                        slabs.append(self._upload(lb[s0:n_in], rb[s0:n_in],
                                                  copy))
                if n_in < B and not last:
                    continue
                lo = chunk_idx * B
                with perf.span("ingest.upload"):
                    if n_in == B:
                        s0 = len(slabs) * slab
                        slabs.append(self._upload(lb[s0:], rb[s0:], copy))
                        if card:
                            compute = torch.cuda.current_stream(self.device)
                            for ld, rd, ev in slabs:
                                compute.wait_event(ev)
                                ld.record_stream(compute)
                                rd.record_stream(compute)
                        lefts = torch.cat([s[0] for s in slabs])
                        rights = torch.cat([s[1] for s in slabs])
                    else:               # partial last chunk: host arrays
                        lefts, rights = lb[:n_in], rb[:n_in]
                if slabs:
                    landed[cur] = slabs[-1][2]
                yield lefts, rights, stamps[lo:lo + n_in], n_in, None
                slabs = []
                chunk_idx += 1
                n_in = 0
                cur ^= 1
        finally:
            if copy is not None:
                with perf.span("ingest.landed"):
                    copy.synchronize()

    def _upload(self, lefts: torch.Tensor, rights: torch.Tensor, copy):
        """(lefts, rights, event) on the device: host rows uploaded without
        blocking on the `copy` stream, the event recorded after them; on
        the CPU the rows themselves (the chunk's concatenation copies
        them before the buffer is refilled) and no event."""
        if copy is None:
            return lefts, rights, None
        perf.count("ingest.bytes", lefts.nbytes + rights.nbytes)
        with torch.cuda.stream(copy):
            ld = lefts.to(self.device, non_blocking=True)
            rd = rights.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy)
        return ld, rd, event

    def _run_async(self, chunks, mapper) -> list[OdomInfo]:
        """Dispatch each (lefts, rights, stamps, n, gts) of `chunks`, and
        unpack it and feed its frames to `mapper` on a consumer thread
        while the next is dispatched.  All mapper work (loop closure
        included) completes before this returns."""
        q: queue.Queue = queue.Queue(maxsize=4)
        results: dict[int, list[OdomInfo]] = {}
        err: list[BaseException] = []

        def consumer():
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                job = q.get()
                if job is None:
                    return
                idx, pending, gts = job
                try:
                    results[idx] = self._consume(pending, gts, mapper)
                except BaseException as e:   # surfaced on the producer
                    err.append(e)
                    return

        t = threading.Thread(target=consumer, daemon=True)
        t.start()
        try:
            for i, (lefts, rights, stamps, n, gts) in enumerate(chunks):
                pending = self.dispatch(lefts, rights, stamps, n)
                with perf.span("pipe.handoff"):
                    _put_or_raise(q, (i, pending, gts), t, err)
        finally:
            with perf.span("pipe.drain"):
                while not err and t.is_alive():  # it may be dead, queue full
                    try:
                        q.put(None, timeout=0.2)
                        break
                    except queue.Full:
                        pass
                t.join()
        if err:
            raise err[0]
        if mapper is not None:
            mapper.join_loop_closure()
        return [info for i in sorted(results) for info in results[i]]

    def _double_buffered(self, chunks, mapper) -> list[OdomInfo]:
        """Dispatch each (lefts, rights, stamps, n, gts) chunk before
        unpacking the one before it."""
        infos: list[OdomInfo] = []
        pending = None
        for lefts, rights, stamps, n, gts in chunks:
            nxt = (self.dispatch(lefts, rights, stamps, n), gts)
            if pending is not None:
                infos.extend(self._consume(*pending, mapper))
            pending = nxt
        if pending is not None:
            infos.extend(self._consume(*pending, mapper))
        if mapper is not None:
            mapper.join_loop_closure()
        return infos

    def _consume(self, pending, gts, mapper) -> list[OdomInfo]:
        with perf.span("pipe.consume", chunk=pending["chunk"],
                       frames=pending["n"]):
            if mapper is not None and pending["dict_handle"] is not None:
                decisions = self._dict_driver.fetch(pending["dict_handle"])
                start, n = pending["start"], pending["n"]
                for j, off in enumerate(self._offsets):
                    if off < n:
                        mapper.word_precomputed[start + off] = (
                            decisions["keep"][j], decisions["unique"][j],
                            decisions["i1"][j], decisions["count_after"][j])
            out = []
            for info, frame in self.collect(pending, gts):
                if mapper is not None:
                    with perf.span("mapper.process", frames=1):
                        mapper.process(frame, info)
                out.append(info)
            return out
