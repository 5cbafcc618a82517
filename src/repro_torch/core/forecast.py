"""Demand forecasting — the predictive half the paper's loop is missing.

The paper's refit is purely reactive: it learns a traffic pattern only
*after* the holes have appeared. Production cache and serving traffic is
strongly periodic (diurnal peaks, out-of-phase tenant cycles), so the
recent past predicts the near future well enough to act on. This module
is the shared forecast layer the reactive consumers plug into:

* :class:`DemandForecaster` — keeps a ring of per-window sketch
  snapshots per *stream* (one stream per controller, tenant, or serving
  stream), detects periodicity by autocorrelation over the per-window
  demand series, and answers :meth:`predict` with the seasonal-naive
  forecast: the recorded window one detected period back from the
  requested horizon — an expected size histogram plus expected demand
  bytes, tagged with the autocorrelation confidence.
* :class:`Reactive` — the null forecaster. ``active`` is False, every
  method is a no-op, ``predict`` returns ``None``: consumers built
  against the seam reproduce today's reactive behaviour bit-for-bit
  (the parity tests in ``tests/test_forecast.py`` hold decisions AND
  sync counts equal).

Consumers (see their modules for the integration contract):

* ``SlabController`` (``ControllerConfig(forecast=...)``) records its
  live sketch at every drift check and fires *predictive* refits when
  the forecast mixture — not the live one — has drifted from the
  reference, pre-positioning the schedule before the peak.
* ``TenantArbiter`` records per-tenant demand per arbitration window
  and prices donors by their forecast demand trajectory: pages are not
  taken from a tenant that is about to need them.

Windows may be host ``(support, weights)`` pairs or dense device weight
tensors (``DeviceSizeSketch.weights_device`` — handing it out marks it
escaped, so the sketch never updates it in place and storing the
reference is a zero-copy, zero-sync snapshot); the periodicity detector
only ever needs the one demand scalar per window.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Forecast:
    """One answer of :meth:`DemandForecaster.predict`.

    Exactly one of ``(support, weights)`` / ``device_weights`` is set,
    matching the representation the windows were recorded in.
    """

    demand_bytes: float          # expected demand at the horizon
    confidence: float            # autocorrelation of the detected period
    period: int                  # detected period, in windows
    horizon: int                 # windows ahead this forecast is for
    support: Optional[np.ndarray] = None     # expected size histogram
    weights: Optional[np.ndarray] = None
    device_weights: Optional[torch.Tensor] = None  # dense weight tensor


@dataclasses.dataclass
class _Window:
    demand_bytes: float
    support: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None
    device_weights: Optional[torch.Tensor] = None


class _Stream:
    __slots__ = ("windows",)

    def __init__(self, ring: int):
        self.windows: Deque[_Window] = deque(maxlen=ring)


class Reactive:
    """The null forecaster: today's behaviour, bit for bit.

    Consumers check ``active`` before doing any forecast work at all, so
    a ``Reactive`` (or ``forecast=None``) consumer records nothing,
    syncs nothing, and decides exactly as the pre-forecast code did.
    """

    active = False

    def record_window(self, stream: str, *, demand_bytes: float = 0.0,
                      support=None, weights=None,
                      device_weights=None) -> None:
        pass

    def predict(self, stream: str, horizon: int = 1) -> Optional[Forecast]:
        return None

    def demand_growth(self, stream: str, horizon: int = 1
                      ) -> Tuple[float, float]:
        """(predicted demand increase in bytes, confidence) — (0, 0)."""
        return 0.0, 0.0


class DemandForecaster:
    """Periodicity-aware seasonal-naive forecaster over window snapshots.

    ``ring`` bounds how many windows are kept per stream; the detector
    needs at least ``min_cycles`` full cycles inside the ring before it
    trusts a period, so the longest detectable period is
    ``ring / min_cycles`` windows. ``min_confidence`` is the
    autocorrelation floor below which :meth:`predict` returns ``None``
    (consumers typically gate again with their own, stricter threshold).

    One forecaster instance serves many *streams* (one per tenant /
    controller); streams share nothing but the configuration.
    """

    active = True

    def __init__(self, *, ring: int = 96, min_cycles: float = 2.0,
                 min_confidence: float = 0.1):
        if ring < 8:
            raise ValueError(f"ring must be >= 8 windows, got {ring}")
        if min_cycles < 1.0:
            raise ValueError(f"min_cycles must be >= 1, got {min_cycles}")
        self.ring = int(ring)
        self.min_cycles = float(min_cycles)
        self.min_confidence = float(min_confidence)
        self._streams: Dict[str, _Stream] = {}
        self.n_windows = 0                 # lifetime windows recorded

    # -- recording -----------------------------------------------------------
    def record_window(self, stream: str, *, demand_bytes: float,
                      support: Optional[np.ndarray] = None,
                      weights: Optional[np.ndarray] = None,
                      device_weights=None) -> None:
        """Append one window snapshot to ``stream``'s ring.

        ``demand_bytes`` is the window's scalar summary (the periodicity
        series). The histogram is optional — the arbiter records demand
        only; the controller records the full sketch so predictive
        refits can score candidate schedules against the forecast
        mixture. ``device_weights`` stores the dense device tensor by
        reference (no copy, no sync — an escaped sketch tensor is never
        updated in place, so the reference is a stable snapshot).
        """
        st = self._streams.get(stream)
        if st is None:
            st = self._streams[stream] = _Stream(self.ring)
        st.windows.append(_Window(
            demand_bytes=float(demand_bytes),
            support=None if support is None else np.asarray(support),
            weights=None if weights is None else np.asarray(weights),
            device_weights=device_weights))
        self.n_windows += 1

    # -- periodicity ---------------------------------------------------------
    def demand_series(self, stream: str) -> np.ndarray:
        st = self._streams.get(stream)
        if st is None:
            return np.zeros(0, dtype=np.float64)
        return np.asarray([w.demand_bytes for w in st.windows],
                          dtype=np.float64)

    def period(self, stream: str) -> Tuple[Optional[int], float]:
        """Detected period (in windows) and its autocorrelation, or
        ``(None, 0.0)``. A lag ``L`` is admissible when ``min_cycles``
        full cycles fit in the recorded series; the winner is the
        best-correlated LOCAL MAXIMUM of the autocorrelation function
        over the centred demand series — a smooth periodic series
        correlates well at every small lag (neighbouring windows look
        alike), so the global max would lock onto lag 2 and never see
        the cycle; the true period is where the ACF *peaks*. A flat
        series has no period (every lag would correlate perfectly, but
        there is nothing to forecast).

        Delegates to :func:`acf_period_batch` with a single row, so the
        scalar answer and the fleet-batched answer go through the one
        implementation and cannot diverge (the bit-parity contract the
        ``TenantArbiter(fleet=True)`` differential suite relies on)."""
        s = self.demand_series(stream)
        lags, confs = acf_period_batch(
            s[None, :], np.array([len(s)], dtype=np.int64),
            min_cycles=self.min_cycles, min_confidence=self.min_confidence)
        if lags[0] < 0:
            return None, 0.0
        return int(lags[0]), float(confs[0])

    # -- prediction ----------------------------------------------------------
    def predict(self, stream: str, horizon: int = 1) -> Optional[Forecast]:
        """Seasonal-naive forecast ``horizon`` windows ahead: the
        recorded window at ``now + horizon - period``. ``None`` when no
        period is detected (or the horizon reaches past one period —
        the seasonal-naive model has nothing to say there)."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        lag, conf = self.period(stream)
        if lag is None or horizon > lag:
            return None
        windows = self._streams[stream].windows
        # index of "now" is len-1; the forecast source is now+h-L
        src = len(windows) - 1 + horizon - lag
        if src < 0:
            return None
        w = windows[src]
        return Forecast(demand_bytes=w.demand_bytes, confidence=conf,
                        period=lag, horizon=horizon, support=w.support,
                        weights=w.weights, device_weights=w.device_weights)

    def demand_growth(self, stream: str, horizon: int = 1
                      ) -> Tuple[float, float]:
        """(predicted demand increase over the current window, in bytes;
        confidence). Positive means the stream is heading into a peak —
        the arbiter's "don't take pages it is about to need" signal.
        Zero (not negative clamped) growth is returned as-is so callers
        can also spot falling demand."""
        fc = self.predict(stream, horizon)
        if fc is None:
            return 0.0, 0.0
        s = self.demand_series(stream)
        return fc.demand_bytes - float(s[-1]), fc.confidence


def acf_period_batch(series: np.ndarray, lengths: np.ndarray, *,
                     min_cycles: float, min_confidence: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ACF peak detection over many demand series at once.

    ``series`` is ``[n_streams, max_len]`` float64, row ``c`` valid over
    ``series[c, :lengths[c]]`` (entries past the length are ignored).
    Returns ``(lags, confs)``: detected period per row (``-1`` for none)
    and its autocorrelation (``0.0`` for none).

    Rows are grouped by length and each group is processed on arrays
    trimmed to exactly that length, with all inner products going
    through one ``np.einsum`` code path. That makes a batch of N rows
    bit-identical to N single-row calls — the reduction order depends
    only on the row length, never on the batch size — which is what
    lets :meth:`DemandForecaster.period` (scalar, legacy arbiter) and
    the fleet-stacked ring (``TenantArbiter(fleet=True)``) share this
    one implementation and stay decision-identical.

    Lengths saturate at the forecaster ring size, so a steady fleet
    collapses to a single group; join/leave churn adds at most one
    group per distinct join cohort.
    """
    series = np.asarray(series, dtype=np.float64)
    lengths = np.asarray(lengths, dtype=np.int64)
    n = series.shape[0]
    lags = np.full(n, -1, dtype=np.int64)
    confs = np.zeros(n, dtype=np.float64)
    for ln in np.unique(lengths):
        max_lag = int(int(ln) / min_cycles)
        if max_lag < 3:
            continue
        idx = np.nonzero(lengths == ln)[0]
        length = int(ln)
        s = series[idx, :length]
        mean = np.einsum("cj->c", s) / float(length)
        s = s - mean[:, None]
        var = np.einsum("cj,cj->c", s, s)
        ok = (var > 0.0) & np.isfinite(var)
        denom_floor = 1e-12 * var
        acf = np.full((len(idx), max_lag + 2), -np.inf)
        for lag in range(1, max_lag + 2):
            if lag >= length:
                break
            a, b = s[:, lag:], s[:, :length - lag]
            denom = np.sqrt(np.einsum("cj,cj->c", a, a)
                            * np.einsum("cj,cj->c", b, b))
            num = np.einsum("cj,cj->c", a, b)
            with np.errstate(divide="ignore", invalid="ignore"):
                vals = num / denom
            acf[:, lag] = np.where(ok & (denom > denom_floor), vals,
                                   -np.inf)
        best_r = np.zeros(len(idx))
        best_lag = np.full(len(idx), -1, dtype=np.int64)
        for lag in range(2, max_lag + 1):
            r, lo, hi = acf[:, lag], acf[:, lag - 1], acf[:, lag + 1]
            # a peak, not a shoulder: both neighbours computed and lower
            cand = (np.isfinite(r) & np.isfinite(lo) & np.isfinite(hi)
                    & (lo <= r) & (r >= hi) & (r > best_r))
            best_lag = np.where(cand, lag, best_lag)
            best_r = np.where(cand, r, best_r)
        good = (best_lag >= 0) & (best_r >= min_confidence)
        lags[idx] = np.where(good, best_lag, -1)
        confs[idx] = np.where(good, best_r, 0.0)
    return lags, confs


def blend_histograms(live: Tuple[np.ndarray, np.ndarray],
                     forecast: Tuple[np.ndarray, np.ndarray],
                     frac_forecast: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Mass-preserving blend of two ``(support, weights)`` histograms.

    The forecast histogram is rescaled to the live histogram's total
    mass first (the two windows were recorded at different decay
    states; only the *shape* of the forecast matters), then blended
    ``(1 - f) * live + f * forecast`` over the merged support. The
    controller scores predictive candidate schedules against this
    mixture, so a pre-positioned schedule must serve both the traffic
    that is here and the traffic that is coming — the first half of the
    anti-thrash hysteresis.
    """
    if not 0.0 <= frac_forecast <= 1.0:
        raise ValueError(
            f"frac_forecast must be in [0, 1], got {frac_forecast}")
    ls, lw = np.asarray(live[0]), np.asarray(live[1], dtype=np.float64)
    fs, fw = np.asarray(forecast[0]), np.asarray(forecast[1],
                                                 dtype=np.float64)
    if ls.size == 0:
        return fs, fw
    if fs.size == 0 or frac_forecast == 0.0:
        return ls, lw
    scale = lw.sum() / max(fw.sum(), 1e-30)
    support = np.union1d(ls, fs)
    out = np.zeros(len(support), dtype=np.float64)
    out[np.searchsorted(support, ls)] += (1.0 - frac_forecast) * lw
    out[np.searchsorted(support, fs)] += frac_forecast * scale * fw
    keep = out > 0.0
    return support[keep], out[keep]
