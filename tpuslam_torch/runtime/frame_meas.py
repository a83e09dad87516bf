"""Frame-timing measurement (frame_meas twin).

A copy of tpuslam/runtime/frame_meas.py (pure Python).  The reference's
programmable logic carries a `frame_meas` block (src/dvp/rtl/
frame_meas.v) that, on a software trigger, measures the incoming video
timing (vertical period, horizontal period, active line and pixel
counts) into readback registers for debug.  This twin measures the frame
stream's timing at the pipeline boundary: trigger once, feed it frame
timestamps (and geometry), read back the same quantities plus running
fps/jitter statistics useful for the streaming mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class FrameMeas:
    """Software twin of the frame_meas register block.

    Usage (mirrors trigger -> measure -> cmpl readback):
        fm = FrameMeas(); fm.trigger()
        for frame in stream: fm.feed(stamp, height, width)
        if fm.complete: print(fm.v_period, fm.fps)
    """
    # readback "registers" (frame_meas.v: v_period/h_period/v_active/h_active)
    v_period: float = 0.0        # seconds per frame
    # NOTE: h_period here is v_period / v_active, which folds vertical
    # blanking into the line time; the RTL measures the hsync period
    # directly (including horizontal blanking).  The twin has no hsync
    # events to observe, so this is a documented approximation.
    h_period: float = 0.0        # seconds per line (v_period / v_active)
    v_active: int = 0            # active lines  (frame height)
    h_active: int = 0            # active pixels (frame width)
    complete: bool = False

    _armed: bool = False
    _prev_stamp: float | None = None
    _periods: list = field(default_factory=list)

    def trigger(self) -> None:
        """Arm a measurement (meas_trig in frame_meas.v): the next two
        frames define one vertical period.  Stream statistics reset too,
        so each trigger starts a fresh measurement run like the RTL
        (fps/jitter never mix samples across runs)."""
        self._armed = True
        self.complete = False
        self._prev_stamp = None
        self._periods.clear()

    def feed(self, stamp: float | None = None, height: int = 0,
             width: int = 0) -> None:
        """One frame event (vsync edge). stamp=None uses the wall clock."""
        if stamp is None:
            stamp = time.monotonic()
        if height:
            self.v_active = height
        if width:
            self.h_active = width
        if self._prev_stamp is not None:
            period = stamp - self._prev_stamp
            self._periods.append(period)
            if self._armed:
                self.v_period = period
                self.h_period = period / self.v_active if self.v_active \
                    else 0.0
                self.complete = True
                self._armed = False
        self._prev_stamp = stamp

    # -- stream statistics (beyond the one-shot register semantics) --------
    @property
    def fps(self) -> float:
        if not self._periods:
            return 0.0
        return len(self._periods) / sum(self._periods)

    @property
    def jitter(self) -> float:
        """Peak-to-peak frame-period variation in seconds."""
        if len(self._periods) < 2:
            return 0.0
        return max(self._periods) - min(self._periods)

    def stats(self) -> dict:
        return dict(v_period=self.v_period, h_period=self.h_period,
                    v_active=self.v_active, h_active=self.h_active,
                    fps=self.fps, jitter=self.jitter,
                    frames=len(self._periods) + 1 if self._prev_stamp
                    is not None else 0)
