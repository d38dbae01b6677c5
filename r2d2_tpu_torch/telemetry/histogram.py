"""Fixed-bucket log-scale histograms, the port's copy of the JAX package's
``telemetry/histogram.py``: the host half, and its device twin
(``bucketize_values``/``value_counts`` on tensors), the one
bucketize-scatter that the learning and the replay diagnostics share
(telemetry/learning.py, telemetry/replaydiag.py).

64 buckets spaced geometrically over 1 us .. 100 s (8 a decade, ~33% a
bucket): one integer increment an observation, percentiles from the
counts, and merging by elementwise addition. The layout is the JAX
package's, so a histogram of either package reads the same.
"""

import math
from typing import Dict, List, Optional

import numpy as np
import torch

NBUCKETS = 64
_LO = 1e-6                   # left edge of bucket 0: 1 us
_DECADES = 8.0               # span: 1 us .. 100 s
_STEP = _DECADES / NBUCKETS  # log10 width of one bucket
_INV_STEP = 1.0 / _STEP
_LOG_LO = math.log10(_LO)




def bucketize_values(x: torch.Tensor) -> torch.Tensor:
    """The device twin of ``bucket_index`` over |x|: int64 bucket indices
    of x's shape, the JAX package's f32 formula ``floor((log10(max(|x|,
    1e-6)) + 6) * 8)`` clipped to [0, 63]; a non-finite value goes to
    the top bucket."""
    ax = x.detach().abs().float()
    i = torch.floor((torch.log10(torch.clamp(ax, min=_LO)) - _LOG_LO)
                    * _INV_STEP)
    # NaN and +inf to the top bucket (|x| has no -inf)
    i = torch.nan_to_num(i, nan=NBUCKETS - 1, posinf=NBUCKETS - 1)
    return i.clamp(0, NBUCKETS - 1).long()


def value_counts(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """(NBUCKETS,) int32 histogram of |x| on x's device: bucketize, then
    one ``scatter_add_`` of ones (or of ``mask``, same shape, 0/1, which
    leaves entries out). No host sync: it runs inside a CUDA graph."""
    idx = bucketize_values(x).reshape(-1)
    ones = (torch.ones_like(idx, dtype=torch.int32) if mask is None
            else mask.reshape(-1).to(torch.int32))
    return torch.zeros(NBUCKETS, dtype=torch.int32,
                       device=x.device).scatter_add_(0, idx, ones)


def bucket_index(seconds: float) -> int:
    """Bucket for one duration; values outside [1 us, 100 s) clamp to the
    end buckets."""
    if seconds <= _LO:
        return 0
    i = int((math.log10(seconds) - _LOG_LO) * _INV_STEP)
    return NBUCKETS - 1 if i >= NBUCKETS else i


def value_counts_np(x: np.ndarray, mask=None) -> np.ndarray:
    """(NBUCKETS,) int64 histogram of |x| (same layout and clamping as
    ``bucket_index``; a non-finite value lands in the top bucket).
    ``mask`` (same shape, 0/1) leaves entries out."""
    ax = np.abs(np.asarray(x, np.float64)).reshape(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        i = np.floor((np.log10(np.maximum(ax, _LO)) - _LOG_LO)
                     * _INV_STEP).astype(np.int64)
    i = np.where(np.isfinite(ax), i, NBUCKETS - 1)
    i = np.clip(i, 0, NBUCKETS - 1)
    if mask is not None:
        i = i[np.asarray(mask, bool).reshape(-1)]
    return np.bincount(i, minlength=NBUCKETS).astype(np.int64)


def bucket_bounds(i: int) -> tuple:
    """(lo, hi) seconds covered by bucket ``i``."""
    return (10.0 ** (_LOG_LO + i * _STEP), 10.0 ** (_LOG_LO + (i + 1) * _STEP))


def bucket_mid(i: int) -> float:
    """Geometric midpoint of bucket ``i``: the value a percentile reports
    for observations there."""
    return 10.0 ** (_LOG_LO + (i + 0.5) * _STEP)


def percentile(counts: np.ndarray, q: float) -> Optional[float]:
    """The q-quantile (0 < q <= 1): the midpoint of the bucket where the
    cumulative count reaches q * total. None for an empty histogram."""
    total = int(counts.sum())
    if total == 0:
        return None
    target = q * total
    cum = 0
    for i in range(len(counts)):
        cum += int(counts[i])
        if cum >= target:
            return bucket_mid(i)
    return bucket_mid(len(counts) - 1)


def summarize(counts: np.ndarray) -> Optional[Dict[str, float]]:
    """Count and P50/P95/P99 in milliseconds; None when empty."""
    total = int(counts.sum())
    if total == 0:
        return None
    out = {"count": total}
    for name, q in (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99)):
        out[name] = round(percentile(counts, q) * 1e3, 4)
    return out


def value_summary(counts: np.ndarray) -> Optional[Dict[str, float]]:
    """``summarize`` for value histograms (batch fills, magnitudes): count
    and P50/P95/P99 in raw units, 6 significant digits; None when
    empty."""
    total = int(np.asarray(counts).sum())
    if total == 0:
        return None
    out = {"count": total}
    for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        out[name] = float(f"{percentile(np.asarray(counts), q):.6g}")
    return out


class LogHistogram:
    """One histogram over the shared layout."""

    def __init__(self, counts: Optional[np.ndarray] = None):
        self.counts = (np.zeros(NBUCKETS, np.int64) if counts is None
                       else np.asarray(counts, np.int64).copy())
        if self.counts.shape != (NBUCKETS,):
            raise ValueError(
                f"histogram counts must have shape ({NBUCKETS},), got "
                f"{self.counts.shape}")

    def add(self, seconds: float) -> None:
        self.counts[bucket_index(seconds)] += 1

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Elementwise sum."""
        return LogHistogram(self.counts + other.counts)

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def percentile(self, q: float) -> Optional[float]:
        return percentile(self.counts, q)

    def summarize(self) -> Optional[Dict[str, float]]:
        return summarize(self.counts)

    def to_list(self) -> List[int]:
        return [int(c) for c in self.counts]
