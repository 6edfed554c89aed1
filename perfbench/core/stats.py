"""The harness's arithmetic on host numbers: whole-window rates, tails over
all requests, and the open-loop schedule. Standard library only."""

from __future__ import annotations

import math
import random
import statistics
from typing import List, Optional, Sequence, Tuple


def rate(count: float, seconds: float) -> float:
    """Work per second over a whole window: all the work done in it over
    all of its time."""
    if seconds <= 0:
        raise ValueError(f"a window must have a positive length, got {seconds}")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value with at least q% of the values at or below it. A
    missing value (a failed request) is ``math.inf``, so it counts as
    missing any limit."""
    if not values:
        raise ValueError("a percentile of no values")
    if not 0 < q <= 100:
        raise ValueError(f"q must lie in (0, 100], got {q}")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def latencies(scheduled: Sequence[float], done: Sequence[Optional[float]]) -> List[float]:
    """Each request's latency from its scheduled arrival (not from when the
    generator got round to sending it), ``inf`` for one that never
    completed or failed."""
    return [math.inf if d is None else d - s for s, d in zip(scheduled, done)]


def poisson_gaps(rate_per_s: float, n: int, seed: int) -> List[float]:
    """``n`` gaps between arrivals of a Poisson process of ``rate_per_s``,
    the same multiset for every ``seed`` and in an order of the seed's.

    The gaps are the exponential distribution's quantiles at
    ``(i + u_i) / n`` with ``u_i`` drawn from a fixed seed: a sample
    of the distribution that every run shares, so that two seeds offer the
    same work and differ only in when it comes."""
    if rate_per_s <= 0 or n < 1:
        raise ValueError(f"need a positive rate and n >= 1, got {rate_per_s}, {n}")
    base = random.Random(0)
    gaps = [-math.log(1.0 - (i + base.random()) / n) / rate_per_s for i in range(n)]
    random.Random(seed).shuffle(gaps)
    return gaps


def schedule(start: float, gaps: Sequence[float]) -> List[float]:
    """Arrival times from ``start`` by the running sum of ``gaps``."""
    out, t = [], start
    for g in gaps:
        t += g
        out.append(t)
    return out


def balanced_choice(n_items: int, n: int, seed: int) -> List[int]:
    """``n`` indices into ``n_items`` items, each used as evenly as ``n``
    allows, in an order of the seed's."""
    picks = [i % n_items for i in range(n)]
    random.Random(seed).shuffle(picks)
    return picks


def in_window(times: Sequence[Optional[float]], lo: float, hi: float) -> int:
    """How many of ``times`` fall in ``(lo, hi]``."""
    return sum(1 for t in times if t is not None and lo < t <= hi)


def lateness(scheduled: Sequence[float], sent: Sequence[float]) -> Tuple[float, float]:
    """(median, largest) seconds by which the generator sent after the
    schedule."""
    late = [s - d for d, s in zip(scheduled, sent)]
    return statistics.median(late), max(late)
