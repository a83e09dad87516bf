"""9-DoF IMU source + hardware-test twin (LSM9DS1).

A copy of tpuslam/io/imu.py (numpy only).  The reference carries an
LSM9DS1 accel/gyro/mag chip interface (src/StereoBM/src/lsm9ds1.c,
lsm9ds1.h:47-119) used only by the `App_9DofHwTest` hardware self-test
(src/StereoBM/src/main.c:679-750); IMU data is never fused into SLAM.
This module provides the same surface: a register-level synthetic
LSM9DS1 (so the self-test logic is exercised end to end without
hardware) and `hw_test_9dof`, a behavioural twin of App_9DofHwTest over
the two MikroBUS sites.

Samples are produced in physical units using the LSM9DS1 power-on
full-scale sensitivities (datasheet table 3: ±2 g -> 0.061 mg/LSB,
±245 dps -> 8.75 mdps/LSB, ±4 gauss -> 0.14 mgauss/LSB) from int16 raw
words, matching what a real register read chain would yield.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# register map surface used by the reference (lsm9ds1.h:47,95,113-114)
XLG_ADDR_WHO_AM_I = 0x0F
MAG_ADDR_WHO_AM_I_M = 0x0F
XLG_WHO_AM_I = 0x68
MAG_WHO_AM_I = 0x3D
MAG_ADDR_CTRL_REG3_M = 0x22
MAG_ADDR_INT_CFG_M = 0x30

# power-on sensitivities (LSM9DS1 datasheet), LSB -> physical
ACCEL_G_PER_LSB = 0.061e-3          # ±2 g
GYRO_DPS_PER_LSB = 8.75e-3          # ±245 dps
MAG_GAUSS_PER_LSB = 0.14e-3         # ±4 gauss


@dataclass
class ImuSample:
    """One 9-DoF reading in physical units."""
    stamp: float
    accel_g: np.ndarray      # (3,) float, g
    gyro_dps: np.ndarray     # (3,) float, deg/s
    mag_gauss: np.ndarray    # (3,) float, gauss


@dataclass
class SyntheticLsm9ds1:
    """Register-level synthetic LSM9DS1 on one MikroBUS site.

    `present=False` simulates an empty site (WHO_AM_I reads fail), which
    the self-test must report as "Device not found" exactly like the
    reference (main.c:744-746).
    """
    present: bool = True
    rate_hz: float = 119.0           # XLG default ODR
    seed: int = 0
    _t: float = 0.0
    _int_enabled: bool = False
    _rng: np.random.Generator = field(default=None, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    # -- register surface --------------------------------------------------
    def xlg_read(self, addr: int) -> int | None:
        """None = I2C transfer failure (device absent)."""
        if not self.present:
            return None
        if addr == XLG_ADDR_WHO_AM_I:
            return XLG_WHO_AM_I
        return 0

    def mag_read(self, addr: int) -> int | None:
        if not self.present:
            return None
        if addr == MAG_ADDR_WHO_AM_I_M:
            return MAG_WHO_AM_I
        return 0

    def mag_write(self, addr: int, value: int) -> bool:
        if not self.present:
            return False
        if addr == MAG_ADDR_INT_CFG_M:
            # 0xE1 = XYZ interrupt enable + INT_M pin enable (main.c:722)
            self._int_enabled = (value & 0xE1) == 0xE1
        return True

    def interrupt_pending(self) -> bool:
        """GPIO data-ready line (fpga->com.GPIO_In bit, main.c:727-731)."""
        return self.present and self._int_enabled

    # -- sampling ------------------------------------------------------------
    def read_sample(self) -> ImuSample:
        """One 9-DoF sample: gravity on +z plus sensor noise, int16
        register words converted at power-on sensitivity."""
        accel_raw = (np.array([0.0, 0.0, 1.0]) / ACCEL_G_PER_LSB +
                     self._rng.normal(0, 30, 3)).astype(np.int16)
        gyro_raw = self._rng.normal(0, 60, 3).astype(np.int16)
        mag_raw = (np.array([0.2, 0.0, 0.4]) / MAG_GAUSS_PER_LSB +
                   self._rng.normal(0, 40, 3)).astype(np.int16)
        s = ImuSample(
            stamp=self._t,
            accel_g=accel_raw.astype(np.float64) * ACCEL_G_PER_LSB,
            gyro_dps=gyro_raw.astype(np.float64) * GYRO_DPS_PER_LSB,
            mag_gauss=mag_raw.astype(np.float64) * MAG_GAUSS_PER_LSB)
        self._t += 1.0 / self.rate_hz
        return s


def hw_test_9dof(devices: list[SyntheticLsm9ds1] | None = None,
                 log=print) -> list[bool]:
    """Behavioral twin of App_9DofHwTest (main.c:679-750): for each of the
    two MB sites, read both WHO_AM_I registers, then enable the magnetometer
    interrupt and poll the data-ready line; report found/not-found.

    Returns per-site found flags.
    """
    if devices is None:
        devices = [SyntheticLsm9ds1(seed=0), SyntheticLsm9ds1(seed=1)]
    results = []
    for ch, dev in enumerate(devices):
        log(f"H/W test on MB site {ch + 1}")
        found = True
        v = dev.xlg_read(XLG_ADDR_WHO_AM_I)
        if v != XLG_WHO_AM_I:
            found = False
        else:
            log(f"XLG WHO_AM_I: {v:02X}")
        v = dev.mag_read(MAG_ADDR_WHO_AM_I_M)
        if v != MAG_WHO_AM_I:
            found = False
        else:
            log(f"MAG WHO_AM_I: {v:02X}")
        if found:
            dev.mag_write(MAG_ADDR_CTRL_REG3_M, 0x00)
            dev.mag_write(MAG_ADDR_INT_CFG_M, 0xE1)
            for _ in range(0x1000):
                if dev.interrupt_pending():
                    log(f"Interrupt from MB{ch + 1} detected")
                    s = dev.read_sample()
                    log(f"mag [gauss]: {s.mag_gauss[0]:+.4f} "
                        f"{s.mag_gauss[1]:+.4f} {s.mag_gauss[2]:+.4f}")
                    break
            else:
                log(f"Interrupt from MB{ch + 1} not detected")
        else:
            log(f"Device not found on MB{ch + 1}")
        results.append(found)
    return results
