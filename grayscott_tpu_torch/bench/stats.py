"""Robust sample statistics for benchmark measurements: the port's copy of
``grayscott_tpu/bench/stats.py`` (plain Python, no device).

- **median** as the central estimate (timing noise only ever inflates);
- **MAD**, made normal-consistent by the 1.4826 factor, as the dispersion;
- **CI95** = median +- 1.96 sigma / sqrt(n), sigma = 1.4826 MAD, floored
  at the half-range or a 0.5 % grain when the MAD degenerates to 0;
- **Tukey fences** at 1.5 IQR (mild) and 3 IQR (severe) for outliers.

Every function takes plain floats and returns plain dicts, so the results
ride in sweep JSON.
"""

from __future__ import annotations

import math
from typing import Sequence

#: Normal-consistency factor: for Gaussian data, sigma = 1.4826 * MAD.
MAD_TO_SIGMA = 1.4826

#: Two-sided 95% normal quantile.
Z95 = 1.959964


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _quartiles(xs: Sequence[float]) -> tuple[float, float]:
    """(Q1, Q3) by the inclusive (Tukey hinge) method — stable at the
    n=5..20 sample counts benchmarks actually use."""
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    lower = s[: mid + (n % 2)]
    upper = s[mid:]
    return _median(lower), _median(upper)


def summarize(samples: Sequence[float]) -> dict:
    """Full sample summary: n, median, MAD, sigma, CI95, min/max, and
    Tukey outlier counts. Raw samples are NOT embedded (callers persist
    them alongside; keeping the summary small lets it ride every sweep
    row)."""
    xs = [float(x) for x in samples]
    if not xs:
        raise ValueError("summarize() needs at least one sample")
    med = _median(xs)
    mad = _median([abs(x - med) for x in xs])
    sig = MAD_TO_SIGMA * mad
    if sig == 0.0:
        # MAD degenerates to 0 whenever >= half the samples are
        # identical (common when rates quantize to the timer grain) —
        # a zero-width CI would then declare ARBITRARILY small deltas
        # significant, the opposite of this module's purpose. Floor the
        # dispersion at the observed half-range, and below that at a
        # 0.5% measurement grain: claiming better-than-half-a-percent
        # precision from samples that all collide is not evidence.
        sig = max((max(xs) - min(xs)) / 2.0, 5e-3 * abs(med))
    half = Z95 * sig / math.sqrt(len(xs))
    q1, q3 = _quartiles(xs)
    iqr = q3 - q1
    mild = sum(1 for x in xs
               if x < q1 - 1.5 * iqr or x > q3 + 1.5 * iqr)
    severe = sum(1 for x in xs
                 if x < q1 - 3.0 * iqr or x > q3 + 3.0 * iqr)
    return {
        "n": len(xs),
        "median": med,
        "mad": mad,
        "sigma": sig,
        "ci95": [med - half, med + half],
        "min": min(xs),
        "max": max(xs),
        "outliers_mild": mild - severe,
        "outliers_severe": severe,
    }


def intervals_overlap(a: Sequence[float], b: Sequence[float]) -> bool:
    """Whether two [lo, hi] intervals overlap — the regression /
    adoption gate: a difference whose CIs overlap is within noise and
    must not drive a decision."""
    return a[0] <= b[1] and b[0] <= a[1]


def significantly_better(
    new: dict, old_value: float, rel_floor: float = 0.0
) -> bool:
    """Whether ``new`` (a summarize() dict) beats a stored point value
    beyond its own noise: the CI95 lower bound must clear
    ``old_value * (1 + rel_floor)``. The stored value usually has no
    dispersion of its own (legacy best-of records), so the new
    measurement's CI carries the whole burden of proof."""
    return new["ci95"][0] > old_value * (1.0 + rel_floor)
