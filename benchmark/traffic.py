"""The one general generator of scan traffic. A traffic mix is a data file
(``traffic/<mix>.json``) of parameters; this module reads it, with the
configuration's sensor block, and makes the world, the course and the scans
from ``--seed``.

Keys of a mix file:

- ``loop``: ``"closed"`` (the next frame is offered once the previous pose
  is back) or ``"open"`` (frame k is due at the window's start + k /
  ``rate_fps``, whether or not the last pose is back).
- ``course``: ``"circle"`` (laps of ``radius`` m at ``frames_per_lap``),
  ``"line"`` (a straight drive at ``step_m`` a frame through a strip world
  as dense as the square one) or ``"city"`` (the city course from frame 0,
  its movers included, in the city that ``world_seed`` draws).
- ``world``: the square world's extent and counts (circle, line).
- ``setup``: ``"first_loop"`` (set-up drives the course until the backend
  has closed a loop and localizes, at most ``setup_max_frames``; the window
  goes on from there) or ``"warmup"`` (``warmup_frames`` frames through a
  throwaway system; the window starts at frame 0 on a new one).
- ``pool_frames`` (closed loop): scans rendered for the window; a window that
  needs more fails. ``rate_fps`` (open loop): the offered rate.
- ``imu`` (optional): ``{"rate_hz", "gyro_noise", "acc_noise"}``; every frame
  but the first then carries the IMU window of the interval that ends at its
  scan (:mod:`.gen.imu`), and a system with a filter has its velocity seeded
  from the course at build (:meth:`Traffic.initial_velocity`).
- ``sweep_motion`` (optional): ``"static"`` (the default; each scan cast from
  one pose) or ``"moving"`` (scan k > 0 motion-blurred from pose k − 1 to pose k,
  :mod:`.gen.moving`; frame 0 stays static).

Scan k's range noise is drawn from a generator seeded by (seed, k) alone, and
IMU window k's noise from one seeded by (seed, 3, k), so one seed gives the
same frames whatever set-up did. Scans are rendered on the card and kept in
host memory, as scans arrive from a sensor; IMU windows are host float32
arrays. A mix without ``imu`` or ``sweep_motion`` renders what it rendered before
they existed, bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .gen import city, imu, moving, sim

FRAME_DT = 0.1  # s of sensor time between scans (10 Hz)


def _seed64(*parts) -> int:
    return int(np.random.SeedSequence([int(p) & (2**64 - 1) for p in parts]).generate_state(
        1, np.uint64)[0] & (2**63 - 1))


class Traffic:
    """The frames of one run. ``scan(k)`` renders frame k of the course (on
    the card, returned in host memory); ``imu(k)`` is its IMU window or None;
    ``frame(k)`` is the two together, as the system under test takes a frame;
    ``stamp(k)`` is its sensor time."""

    def __init__(self, mix: dict, sensor: dict, seed: int, device, n_frames: int):
        self.mix = mix
        self.seed = seed
        self.device = torch.device(device)
        rng = np.random.default_rng(_seed64(seed, 1))
        course = mix["course"]
        if course == "circle":
            self.world = sim.make_world(rng, **mix["world"])
            self.movers = None

            def course_of(n):
                return sim.circle_course(n, mix["frames_per_lap"], mix["radius"], mix["z"])
        elif course == "line":
            w = dict(mix["world"])
            e = w.pop("extent")
            length = mix["step_m"] * n_frames + 2 * e
            scale = length / (2 * e)  # area of the strip over the square's
            self.world = sim.make_world(rng, extent=length / 2, extent_y=e,
                                        n_boxes=round(w.pop("n_boxes") * scale),
                                        n_cylinders=round(w.pop("n_cylinders") * scale), **w)
            self.movers = None

            def course_of(n):
                return sim.line_course(n, mix["step_m"], -length / 2 + e, z=mix["z"])
        elif course == "city":
            # one city for every seed (the seed draws the range noise): the
            # world decides when loops close and how long solves take
            wrng = np.random.default_rng(mix["world_seed"])
            self.world = city.make_city_world(int(wrng.integers(2**31 - 1)))
            self.movers = city.make_movers(int(wrng.integers(2**31 - 1)))
            whole = city.make_city_course()

            def course_of(n):
                return whole[:n]
        else:
            raise ValueError(f"unknown course {course!r}")
        self.poses = course_of(n_frames)
        if self.poses.shape[0] < n_frames:
            raise ValueError(f"the course has {self.poses.shape[0]} frames, {n_frames} asked for")
        self.renderer = sim.Renderer(device=device, **sensor)
        self._gen = torch.Generator(device=self.device)
        self.sweep = mix.get("sweep_motion", "static")
        if self.sweep not in ("static", "moving"):
            raise ValueError(f"unknown sweep_motion {self.sweep!r}")
        self.imu_spec = mix.get("imu")
        if self.imu_spec is not None:
            # the course one frame past the last, so that the last frame's
            # central-difference velocity does not depend on the run's length
            self._rates = imu.course_rates(course_of(n_frames + 1), 1.0 / FRAME_DT)

    def scan(self, k: int):
        world = self.world if self.movers is None else city.world_with_movers(
            self.world, self.movers, k)
        self._gen.manual_seed(_seed64(self.seed, 2, k))
        r = self.renderer
        normals = torch.randn(r.rings * r.width, generator=self._gen, device=self.device)
        if self.sweep == "moving" and k > 0:
            xyz, mask, attr = moving.scan_moving(r, world, self.poses[k - 1], self.poses[k],
                                                 normals)
        else:
            xyz, mask, attr = r.scan(world, self.poses[k], normals)
        return xyz.cpu(), mask.cpu(), attr.cpu()

    def imu(self, k: int):
        """(gyro (M,3), acc (M,3), dts (M,)) float32 host arrays of the
        interval ending at scan k, or None (no ``imu`` key, or frame 0)."""
        if self.imu_spec is None or k == 0:
            return None
        spec = self.imu_spec
        v, yaw = self._rates
        return imu.imu_window(v, yaw, k, np.random.default_rng(_seed64(self.seed, 3, k)),
                              scan_hz=1.0 / FRAME_DT, imu_hz=spec["rate_hz"],
                              gyro_noise=spec["gyro_noise"], acc_noise=spec["acc_noise"])

    def frame(self, k: int):
        """(scan, IMU window or None) of frame k."""
        return self.scan(k), self.imu(k)

    def initial_velocity(self):
        """The course's velocity at frame 0 in its body frame, or None
        without ``imu``."""
        if self.imu_spec is None:
            return None
        return imu.initial_velocity(self.poses[:2], 1.0 / FRAME_DT)

    @staticmethod
    def stamp(k: int) -> float:
        return FRAME_DT * k


def frames_needed(mix: dict, seconds: float) -> int:
    """Frames of the course a run may touch: set-up's and the window's."""
    if mix["loop"] == "open":
        return int(math.ceil(mix["rate_fps"] * seconds))
    extra = mix.get("setup_max_frames", 0)
    return extra + mix["pool_frames"]
