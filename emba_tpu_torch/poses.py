"""Front-end pose management: loading, interpolated queries, subsets
(counterpart of ``emba_tpu/poses.py``, numpy only).

Replaces the reference's ``utils::PoseManager``
(``include/utils/pose_manager.h:11-39``, ``src/utils/pose_manager.cpp``):
TUM-format loading with time offset, SO(3) geodesic interpolation at a query
time, and time-range subset extraction.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import io as eio
from . import spline


@dataclasses.dataclass
class PoseManager:
    times: np.ndarray  # (M,) sorted
    rotations: np.ndarray  # (M, 3, 3)

    @classmethod
    def from_tum(cls, path: str, time_offset: float = 0.0) -> "PoseManager":
        """Load a TUM trajectory txt (reference ``loadPoses``,
        pose_manager.cpp:7-39)."""
        t, r = eio.load_tum_trajectory(path, time_offset=time_offset)
        return cls(times=t, rotations=r)

    def pose_at(self, t_query: float) -> np.ndarray:
        """SO(3) geodesic interpolation at a query time (reference
        ``getPoseAt``, pose_manager.cpp:82-108): clamp outside the span,
        slerp between neighbors inside."""
        if t_query <= self.times[0]:
            return self.rotations[0]
        if t_query >= self.times[-1]:
            return self.rotations[-1]
        i2 = int(np.searchsorted(self.times, t_query, side="right"))
        i1 = i2 - 1
        a = (t_query - self.times[i1]) / (self.times[i2] - self.times[i1])
        R1, R2 = self.rotations[i1], self.rotations[i2]
        rel = spline._np_log(R1.T @ R2)
        return R1 @ spline._np_exp(a * rel)

    def subset(self, t1: float, t2: float) -> "PoseManager":
        """Poses with t1 < t < t2 (reference ``getPoseSubset``,
        pose_manager.cpp:110-120: upper_bound(t1) .. lower_bound(t2))."""
        m = (self.times > t1) & (self.times < t2)
        return PoseManager(times=self.times[m], rotations=self.rotations[m])

    def __len__(self) -> int:
        return len(self.times)

    def interp_mid(self, i: int, j: int):
        """Midpoint interpolation between poses i and j (reference
        ``Trajectory::interpPoseMid``, trajectory.cpp:7-20)."""
        t_mid = self.times[i] + 0.5 * (self.times[j] - self.times[i])
        return t_mid, self.pose_at(t_mid)
