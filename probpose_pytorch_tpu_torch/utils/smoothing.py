"""Temporal keypoint smoothing for video streams (one-euro filter; a copy of
probpose_pytorch_tpu/utils/smoothing.py, which the port cannot import).

Companion to `TopDownPredictor.predict_stream`: per-frame pose estimates
jitter at the sub-pixel level; the one-euro filter (Casiez et al., CHI 2012)
removes that jitter with speed-adaptive smoothing — heavy at rest (low
cutoff), light under motion (cutoff grows with velocity) — so latency stays
imperceptible while static poses stop trembling.

Host-side NumPy: state is per-tracked-person and updates once per frame;
this is control-plane work, not chip work. The reference has no video
pipeline at all (SURVEY.md §2.4).
"""

from __future__ import annotations

import numpy as np

__all__ = ["OneEuroFilter", "PoseSmoother"]


def _smoothing_factor(cutoff: np.ndarray | float, dt: float) -> np.ndarray:
    tau = 1.0 / (2.0 * np.pi * np.asarray(cutoff, np.float64))
    return 1.0 / (1.0 + tau / dt)


class OneEuroFilter:
    """One-euro filter over an arbitrary-shape float array signal.

    min_cutoff: jitter floor (Hz) — lower = smoother at rest.
    beta: speed coefficient — higher = faster cutoff growth under motion.
    d_cutoff: derivative low-pass cutoff (Hz).
    """

    def __init__(
        self,
        min_cutoff: float = 1.0,
        beta: float = 0.007,
        d_cutoff: float = 1.0,
    ):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self._x: np.ndarray | None = None
        self._dx: np.ndarray | None = None
        self._t: float | None = None

    def __call__(self, x: np.ndarray, t: float) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self._x is None:
            self._x, self._dx, self._t = x.copy(), np.zeros_like(x), float(t)
            return x.astype(np.float32)
        dt = float(t) - self._t
        if dt <= 0:
            return self._x.astype(np.float32)
        self._t = float(t)
        dx = (x - self._x) / dt
        a_d = _smoothing_factor(self.d_cutoff, dt)
        self._dx = a_d * dx + (1.0 - a_d) * self._dx
        cutoff = self.min_cutoff + self.beta * np.abs(self._dx)
        a = _smoothing_factor(cutoff, dt)
        self._x = a * x + (1.0 - a) * self._x
        return self._x.astype(np.float32)


class PoseSmoother:
    """One-euro smoothing over streams of (K, 2) poses keyed by track id.

    update(keypoints (N, K, 2), track_ids (N,), t) -> smoothed (N, K, 2).
    Track association is the caller's concern (detector/tracker ids, or
    stable box order); unseen ids start fresh, ids absent for more than
    `max_gap` seconds are dropped.
    """

    def __init__(
        self,
        min_cutoff: float = 1.0,
        beta: float = 0.007,
        d_cutoff: float = 1.0,
        max_gap: float = 1.0,
    ):
        self._kw = dict(min_cutoff=min_cutoff, beta=beta, d_cutoff=d_cutoff)
        self.max_gap = float(max_gap)
        self._filters: dict = {}
        self._last_seen: dict = {}

    def update(
        self, keypoints: np.ndarray, track_ids, t: float
    ) -> np.ndarray:
        kpts = np.asarray(keypoints, np.float32)
        out = np.empty_like(kpts)
        for i, tid in enumerate(track_ids):
            f = self._filters.get(tid)
            if f is None:
                f = self._filters[tid] = OneEuroFilter(**self._kw)
            out[i] = f(kpts[i], t)
            self._last_seen[tid] = float(t)
        stale = [
            tid
            for tid, seen in self._last_seen.items()
            if float(t) - seen > self.max_gap
        ]
        for tid in stale:
            self._filters.pop(tid, None)
            self._last_seen.pop(tid, None)
        return out
