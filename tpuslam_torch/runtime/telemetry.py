"""Live frame telemetry: the UVC stream analog for realtime mode.

Counterpart of tpuslam/runtime/telemetry.py.  The reference board presents
itself as a USB webcam and streams the rectified / raw / disparity frame
of every processed bank while the SLAM loop runs
(the reference's src/StereoBM/src/xusb_main.c:166-199, xusb_ch9_video.c
UVC descriptors).  The analog is a drop-oldest ring of image files on
disk plus a `latest.json` pointer: any observer (browser refresh,
`watch`, a dashboard) can follow the live run without touching the
pipeline's timing:

  * `publish()` never blocks the SLAM loop: frames go through a depth-1
    queue to a writer thread, and when the writer is busy new frames
    replace the queued one (the UVC behavior of streaming the most recent
    bank and skipping frames the host isn't ready for).
  * the ring holds the last `ring` frames; `latest.json` is updated by
    atomic rename so a reader never sees a torn pointer.

tpuslam's writer thread saves its PNGs with Pillow; this one with the
port's zlib PNG writer (io/png.py), which the port reads without Pillow.
The pixels are the same; everything else is tpuslam's code.
"""

from __future__ import annotations

import json
import os
import queue
import threading

import numpy as np


class TelemetrySink:
    def __init__(self, out_dir: str, ring: int = 8):
        self.out_dir = out_dir
        self.ring = ring
        os.makedirs(out_dir, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = False
        self._published = 0
        self._dropped = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- producer side (SLAM loop) -------------------------------------
    def publish(self, frame_id: int, stamp: float,
                left: np.ndarray | None = None,
                disparity: np.ndarray | None = None) -> None:
        """Non-blocking: enqueue the newest frame, dropping the queued
        one if the writer is behind (xusb_main.c streams the latest
        bank, never a backlog)."""
        item = (int(frame_id), float(stamp), left, disparity)
        while True:
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self._dropped += 1
                except queue.Empty:
                    pass

    def close(self) -> None:
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=30)

    @property
    def stats(self) -> dict:
        return {"published": self._published, "dropped": self._dropped}

    # -- writer thread --------------------------------------------------
    def _worker(self):
        from ..io.png import write_png
        while True:
            item = self._q.get()
            if item is None or self._stop:
                return
            frame_id, stamp, left, disparity = item
            slot = frame_id % self.ring
            names = {}
            if left is not None:
                p = os.path.join(self.out_dir, f"rect_{slot}.png")
                write_png(p, np.asarray(left, np.uint8))
                names["rect"] = os.path.basename(p)
            if disparity is not None:
                # int16 x16 subpixel -> u8 visualization, like the UVC
                # stream's BM view (full range onto 0..255)
                d = np.asarray(disparity, np.float32) / 16.0
                lo, hi = 0.0, max(float(d.max()), 1.0)
                vis = np.clip((d - lo) / (hi - lo) * 255.0, 0,
                              255).astype(np.uint8)
                p = os.path.join(self.out_dir, f"disp_{slot}.png")
                write_png(p, vis)
                names["disp"] = os.path.basename(p)
            tmp = os.path.join(self.out_dir, ".latest.tmp")
            with open(tmp, "w") as fh:
                json.dump({"frame_id": frame_id, "stamp": stamp,
                           "slot": slot, **names}, fh)
            os.replace(tmp, os.path.join(self.out_dir, "latest.json"))
            self._published += 1
