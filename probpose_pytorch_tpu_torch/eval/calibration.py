"""Confidence-calibration metrics for the probabilistic keypoint branches
(a copy of probpose_pytorch_tpu/eval/calibration.py, which the port cannot
import).

ProbPose's distinguishing outputs are per-keypoint probabilities — presence
in the crop (trained against the codec's `in_image` target, reference
loss.py:428-464 pairing) and visibility. Downstream consumers threshold
them (the reference inference script draws keypoints at p >= 0.9,
inference.py:64-66), so their CALIBRATION — does p = 0.9 mean "right 90% of
the time"? — is a first-class quality axis next to AP. The reference has no
calibration surface (SURVEY §2.4 absence list); this module is greenfield.

Pure NumPy, host-side (runs on eval outputs, never on the device):

- equal-width reliability binning (`reliability_bins`)
- ECE / MCE (Naeini et al., AAAI 2015), Brier score, NLL
- single-parameter temperature scaling (Guo et al., ICML 2017) fitted by
  golden-section search on NLL over log T — the branches emit sigmoid
  probabilities, so scaling happens in logit space.

`calibration_report` bundles everything, including post-temperature ECE/NLL
so a report states both how miscalibrated the branch is and how much of it
one scalar fixes. The eval pipeline threads these through
`evaluate_topdown(..., calibration=True)`.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "reliability_bins",
    "expected_calibration_error",
    "max_calibration_error",
    "brier_score",
    "nll",
    "fit_temperature",
    "apply_temperature",
    "balanced_accuracy",
    "calibration_report",
]

# f32-representable probability clip (see losses.binary_cross_entropy: XLA
# flushes subnormals, and 1 - 1e-12 rounds to 1.0 in f32). Host-side math
# here is f64, but predictions arrive from an f32 device — mirror the same
# floor so logit() of a saturated branch output stays finite. Public: the
# predictor's on-device temperature application uses the same clip.
P_LO = 1.1754944e-38
P_HI = 1.0 - 6e-8


def _as_pairs(p: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    p = np.asarray(p, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    if p.shape != y.shape:
        raise ValueError(f"shape mismatch: p {p.shape} vs y {y.shape}")
    return p, y


def reliability_bins(
    p: np.ndarray, y: np.ndarray, n_bins: int = 15
) -> dict[str, np.ndarray]:
    """Equal-width reliability histogram over [0, 1].

    Returns dict of per-bin arrays (length n_bins): `edges` (n_bins+1),
    `confidence` (mean predicted p; NaN for empty bins), `accuracy`
    (empirical positive rate; NaN for empty bins), `count`.
    """
    p, y = _as_pairs(p, y)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    # right-closed last bin so p == 1.0 lands in bin n_bins-1
    idx = np.minimum((p * n_bins).astype(np.int64), n_bins - 1)
    count = np.bincount(idx, minlength=n_bins).astype(np.float64)
    conf_sum = np.bincount(idx, weights=p, minlength=n_bins)
    acc_sum = np.bincount(idx, weights=y, minlength=n_bins)
    with np.errstate(invalid="ignore", divide="ignore"):
        confidence = conf_sum / count
        accuracy = acc_sum / count
    return dict(
        edges=edges, confidence=confidence, accuracy=accuracy, count=count
    )


def expected_calibration_error(
    p: np.ndarray, y: np.ndarray, n_bins: int = 15
) -> float:
    """ECE: count-weighted mean |accuracy - confidence| over bins."""
    b = reliability_bins(p, y, n_bins)
    mask = b["count"] > 0
    w = b["count"][mask] / b["count"].sum()
    return float(
        np.sum(w * np.abs(b["accuracy"][mask] - b["confidence"][mask]))
    )


def max_calibration_error(
    p: np.ndarray, y: np.ndarray, n_bins: int = 15
) -> float:
    """MCE: worst-bin |accuracy - confidence| (non-empty bins)."""
    b = reliability_bins(p, y, n_bins)
    mask = b["count"] > 0
    if not mask.any():
        return 0.0
    return float(
        np.max(np.abs(b["accuracy"][mask] - b["confidence"][mask]))
    )


def brier_score(p: np.ndarray, y: np.ndarray) -> float:
    p, y = _as_pairs(p, y)
    return float(np.mean((p - y) ** 2))


def nll(p: np.ndarray, y: np.ndarray) -> float:
    """Mean binary negative log-likelihood (base e), saturation-clipped."""
    p, y = _as_pairs(p, y)
    p = np.clip(p, P_LO, P_HI)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log1p(-p)))


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(p, np.float64), P_LO, P_HI)
    return np.log(p) - np.log1p(-p)


def apply_temperature(p: np.ndarray, temperature: float) -> np.ndarray:
    """Rescale sigmoid probabilities by 1/T in logit space."""
    z = _logit(p) / float(temperature)
    # Stable sigmoid.
    ez = np.exp(-np.abs(z))
    return np.where(z >= 0, 1.0 / (1.0 + ez), ez / (1.0 + ez))


def fit_temperature(
    p: np.ndarray,
    y: np.ndarray,
    log_t_bounds: tuple[float, float] = (math.log(1 / 50), math.log(50)),
    tol: float = 1e-4,
) -> float:
    """Fit the scalar temperature minimizing NLL of sigmoid(logit(p)/T).

    Golden-section search on log T — NLL(T) is unimodal in T for the
    one-parameter family (it is a 1-D exponential-family MLE), so bracketed
    search needs no gradients and cannot diverge. Returns T (1.0 = already
    calibrated; > 1 = overconfident predictions get softened).
    """
    p, y = _as_pairs(p, y)
    if len(p) == 0 or y.min() == y.max():
        # Degenerate: no data or one class — temperature is unidentifiable
        # (NLL decreases monotonically toward a saturating T); keep identity.
        return 1.0
    z = _logit(p)

    def f(log_t: float) -> float:
        zz = z / math.exp(log_t)
        # log(1 + e^-|z|) stable NLL on logits.
        return float(
            np.mean(np.log1p(np.exp(-np.abs(zz))) + np.maximum(-zz, 0) * y
                    + np.maximum(zz, 0) * (1.0 - y))
        )

    lo, hi = log_t_bounds
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    while b - a > tol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    return float(math.exp((a + b) / 2.0))


def balanced_accuracy(
    p: np.ndarray,
    y: np.ndarray,
    thresholds: np.ndarray | None = None,
) -> float | None:
    """Best-threshold balanced binary accuracy, (TPR+TNR)/2 maximized over
    the reference's threshold sweep 0.1..0.95 (loss.py:653-697 — the exact
    deterministic form of its randomized balanced subsampling; see
    eval/metrics_host.balanced_binary_accuracy_sampled for the sampled
    twin). 0.5 = chance, i.e. the branch carries no signal."""
    p, y = _as_pairs(p, y)
    if len(p) == 0 or y.min() == y.max():
        # None (not NaN): callers json.dumps these reports, and a bare NaN
        # token makes the artifact invalid strict JSON.
        return None
    if thresholds is None:
        thresholds = np.arange(0.10, 0.96, 0.05)
    pos = y > 0.5
    best = 0.0
    for thr in thresholds:
        pred = p >= thr
        tpr = float(pred[pos].mean()) if pos.any() else 0.0
        tnr = float((~pred[~pos]).mean()) if (~pos).any() else 0.0
        best = max(best, (tpr + tnr) / 2)
    return best


def calibration_report(
    p: np.ndarray, y: np.ndarray, n_bins: int = 15
) -> dict[str, object]:
    """Full calibration summary for one probability branch.

    Keys: n, positive_rate, balanced_acc (best-threshold (TPR+TNR)/2 — 0.5
    means no signal), ece, mce, brier, nll, temperature, ece_scaled,
    nll_scaled (after temperature scaling), and `bins` (the reliability
    histogram, JSON-friendly lists).
    """
    p, y = _as_pairs(p, y)
    t = fit_temperature(p, y)
    p_scaled = apply_temperature(p, t)
    b = reliability_bins(p, y, n_bins)
    return dict(
        n=int(len(p)),
        positive_rate=float(y.mean()) if len(y) else 0.0,
        balanced_acc=balanced_accuracy(p, y),
        ece=expected_calibration_error(p, y, n_bins),
        mce=max_calibration_error(p, y, n_bins),
        brier=brier_score(p, y),
        nll=nll(p, y),
        temperature=t,
        ece_scaled=expected_calibration_error(p_scaled, y, n_bins),
        nll_scaled=nll(p_scaled, y),
        bins={
            k: [None if isinstance(v, float) and math.isnan(v) else float(v)
                for v in arr]
            for k, arr in b.items()
        },
    )
