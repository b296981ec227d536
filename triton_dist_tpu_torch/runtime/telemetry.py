"""Serving telemetry: a metrics registry, per-request lifecycle
latencies, and an optional poll-loop timeline.

Counterpart of triton_dist_tpu/runtime/telemetry.py (`Counter`, `Gauge`,
`Histogram`, `MetricsRegistry`, `Telemetry`) as far as the scheduler and
the prefix cache use it. Host-side only: no tensor is touched here.

- METRICS REGISTRY: counters, gauges and log-bucketed histograms under
  one lock; `snapshot()` is a deep, single-point-in-time copy, which is
  what `ContinuousScheduler.stats()` returns.
- REQUEST LIFECYCLE: `queued` -> first delivery -> deliveries ->
  retirement, stamped on the host's monotonic clock, deriving the
  `ttft_ms`, `inter_token_ms` and `request_latency_ms` histograms; every
  scheduler poll records `poll_ms`. These are host wall times: they
  include device time only because the scheduler's token readback
  synchronises with the card.
- TIMELINE (trace=True only): host phase spans nested under each poll,
  device-occupancy spans from dispatch to readback, and instants
  (preemptions), as Chrome trace-event JSON (`export`, `dump`). With
  tracing off every trace entry point returns at once.

- LABELLED SERIES: a counter or gauge registered with labels lives under
  `labeled_name(name, labels)`, e.g. `expert_tokens{expert=3}`, in the
  registry and in its snapshots.

Not ported yet (they come with TokenServer): SLO classes, the
Prometheus exposition and trace splicing.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np


def labeled_name(name: str, labels: Optional[Dict[str, str]]) -> str:
    """The registry and snapshot key of a metric: `name` alone, or
    `name{k=v,...}` with the labels sorted."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic event counter (a plain int add: one writer, the polling
    thread)."""

    __slots__ = ("name", "help", "_v")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0

    def inc(self, n: int = 1) -> None:
        self._v += n

    @property
    def value(self) -> int:
        return self._v

    def snapshot(self):
        return self._v


class Gauge:
    """Point-in-time value (pool occupancy, an EMA, a queue depth)."""

    __slots__ = ("name", "help", "_v")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        return self._v


class Histogram:
    """Log-bucketed latency histogram over FIXED numpy bins.

    Bucket i >= 1 covers [lo * growth**(i-1), lo * growth**i); bucket 0
    is the underflow sink (values below `lo`, zero, negative, NaN), the
    last bucket the overflow sink (its sum contribution clamps +inf to
    the top edge). `record()` is O(1) and allocation-free; `quantile(q)`
    returns the geometric midpoint of the bucket holding the rank, so
    its relative error against the exact sample percentile is at most
    sqrt(growth) (about 9% at the default growth of 2**0.25)."""

    __slots__ = ("name", "help", "lo", "growth", "edges", "counts", "n",
                 "total", "_log_lo", "_inv_log_g", "_nbins", "_top")

    def __init__(self, name: str, help: str = "", *, lo: float = 0.01,
                 hi: float = 6e5, growth: float = 2.0 ** 0.25):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError(f"bad histogram bounds: lo={lo} hi={hi} "
                             f"growth={growth}")
        self.name = name
        self.help = help
        self.lo = float(lo)
        self.growth = float(growth)
        self._nbins = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        self.edges = self.lo * self.growth ** np.arange(self._nbins + 1,
                                                        dtype=np.float64)
        self.counts = np.zeros((self._nbins + 2,), np.int64)
        self.n = 0
        self.total = 0.0
        self._log_lo = math.log(self.lo)
        self._inv_log_g = 1.0 / math.log(self.growth)
        self._top = float(self.edges[-1])

    def record(self, v) -> None:
        v = float(v)
        if not v >= self.lo:        # below lo, zero, negative, or NaN
            i = 0
            v = max(v, 0.0) if v == v else 0.0
        elif v >= self._top:
            i = self._nbins + 1
            if v == math.inf:
                v = self._top
        else:
            i = int((math.log(v) - self._log_lo) * self._inv_log_g) + 1
            if i > self._nbins:
                i = self._nbins + 1
        self.counts[i] += 1
        self.n += 1
        self.total += v

    def quantile(self, q: float) -> float:
        """q in [0, 1]: geometric-midpoint estimate of the q-th sample
        quantile (0.0 when empty; clamped to [lo, top edge])."""
        if self.n == 0:
            return 0.0
        rank = q * (self.n - 1)
        c = 0
        for i in range(len(self.counts)):
            c += int(self.counts[i])
            if c > rank:
                if i == 0:
                    return float(self.edges[0])
                if i > self._nbins:
                    return float(self.edges[-1])
                return float(math.sqrt(self.edges[i - 1] * self.edges[i]))
        return float(self.edges[-1])

    def snapshot(self) -> dict:
        n = self.n
        return {
            "count": int(n),
            "sum": round(float(self.total), 3),
            "mean": round(float(self.total) / n, 3) if n else 0.0,
            "p50": round(self.quantile(0.50), 3),
            "p95": round(self.quantile(0.95), 3),
            "p99": round(self.quantile(0.99), 3),
        }


class MetricsRegistry:
    """Named metrics with get-or-create accessors and DEEP snapshots
    (nothing in a snapshot aliases live state). The lock is reentrant
    and exposed so a caller can refresh gauges and snapshot in one
    consistent cut."""

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: Dict[str, object] = {}

    def _get(self, key: str, cls, help: str, **kw):
        with self.lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(key, help, **kw)
            elif type(m) is not cls:
                raise TypeError(f"metric {key!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "", *,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(labeled_name(name, labels), Counter, help)

    def gauge(self, name: str, help: str = "", *,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(labeled_name(name, labels), Gauge, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(name, Histogram, help, **kw)

    def snapshot(self) -> dict:
        with self.lock:
            return {name: m.snapshot() for name, m in self._metrics.items()}


class _Req:
    """Per-request lifecycle stamps (and the event list when tracing)."""

    __slots__ = ("t_q", "t_first", "t_last", "n", "ev")

    def __init__(self, t: float, traced: bool):
        self.t_q = t
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.n = 0
        self.ev: Optional[list] = [] if traced else None


class _NullSpan:
    """The tracing-off phase context: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One host-track phase span (a Chrome 'X' event, emitted on exit)."""

    __slots__ = ("_tele", "_name", "_t0")

    def __init__(self, tele: "Telemetry", name: str):
        self._tele = tele
        self._name = name

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._tele._span(self._name, self._t0, time.monotonic(), tid=0)
        return False


class _PollSpan:
    """Wraps one scheduler poll: records `poll_ms` always, and the poll's
    timeline span when tracing."""

    __slots__ = ("_tele", "_t0")

    def __init__(self, tele: "Telemetry"):
        self._tele = tele

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        tele = self._tele
        t1 = time.monotonic()
        tele.h_poll.record((t1 - self._t0) * 1e3)
        if tele.trace:
            tele._poll_seq += 1
            tele._span("poll", self._t0, t1, tid=0, args={"seq": tele._poll_seq})
        return False


class Telemetry:
    """One scheduler's telemetry bundle: registry + request lifecycle +
    poll timeline. The always-on half is the registry and the latency
    histograms; the trace half (event lists, timeline) is gated on
    `self.trace`. `queued`/`retire` take a small lock, so submit() from
    another thread never races the polling thread's dict updates."""

    _STATUSES = ("retired", "cancelled", "rejected")

    def __init__(self, *, trace: bool = False):
        self.registry = MetricsRegistry()
        self.trace = bool(trace)
        self._lock = threading.RLock()
        self._t0 = time.monotonic()
        r = self.registry
        self.h_ttft = r.histogram("ttft_ms", "queued -> first token, per request")
        self.h_itl = r.histogram("inter_token_ms", "gap between consecutive "
                                                   "deliveries of one stream")
        self.h_e2e = r.histogram("request_latency_ms",
                                 "queued -> retirement, per request")
        self.h_poll = r.histogram("poll_ms", "scheduler poll duration")
        self._c_status = {s: r.counter("requests_" + s) for s in self._STATUSES}
        self._live: Dict[object, _Req] = {}
        self._retired: deque = deque(maxlen=512)       # traced requests kept
        self._events: deque = deque(maxlen=65536)      # timeline events kept
        self._dispatch = None           # pending device-track stamp
        self._poll_seq = 0

    def _ms(self, t: float) -> float:
        return round((t - self._t0) * 1e3, 3)

    # request lifecycle ------------------------------------------------

    def queued(self, rid) -> None:
        t = time.monotonic()
        with self._lock:
            rec = self._live.get(rid)
            if rec is None:
                rec = self._live[rid] = _Req(t, self.trace)
        if rec.ev is not None:
            rec.ev.append([self._ms(t), "queued", None])

    def req_event(self, rid, name: str, detail=None) -> None:
        """Trace-only annotation on a live request (admitted, resume,
        preempt)."""
        if not self.trace:
            return
        rec = self._live.get(rid)
        if rec is not None and rec.ev is not None:
            rec.ev.append([self._ms(time.monotonic()), name, detail])

    def emit(self, rid, n: int) -> None:
        """One delivery of n tokens to rid's stream: the first gives
        ttft_ms, every later one an inter_token_ms sample."""
        t = time.monotonic()
        rec = self._live.get(rid)
        if rec is None:
            return
        if rec.t_first is None:
            rec.t_first = t
            self.h_ttft.record((t - rec.t_q) * 1e3)
            if rec.ev is not None:
                rec.ev.append([self._ms(t), "first_token", int(n)])
        else:
            self.h_itl.record((t - rec.t_last) * 1e3)
            if rec.ev is not None:
                rec.ev.append([self._ms(t), "tokens", int(n)])
        rec.t_last = t
        rec.n += n

    def retire(self, rid, status: str = "retired") -> None:
        """Final transition; a repeat retire of the same rid is a no-op."""
        t = time.monotonic()
        with self._lock:
            rec = self._live.pop(rid, None)
        if rec is None:
            return
        self.h_e2e.record((t - rec.t_q) * 1e3)
        self._c_status[status].inc()
        if rec.ev is not None:
            rec.ev.append([self._ms(t), status, None])
            ttft = (round((rec.t_first - rec.t_q) * 1e3, 3)
                    if rec.t_first is not None else None)
            with self._lock:
                self._retired.append((rid, {"status": status, "tokens": rec.n,
                                            "ttft_ms": ttft, "events": rec.ev}))

    # poll-loop timeline (tracing only; host tid 0, device tid 1) ------

    def _span(self, name: str, t0: float, t1: float, *, tid: int,
              args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "X", "pid": 0, "tid": tid,
              "ts": round((t0 - self._t0) * 1e6, 1),
              "dur": round((t1 - t0) * 1e6, 1)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def poll_span(self) -> _PollSpan:
        return _PollSpan(self)

    def phase(self, name: str):
        """Host-track phase span (bookkeep/step/retire); the shared null
        context when tracing is off."""
        if not self.trace:
            return _NULL_SPAN
        return _Span(self, name)

    def mark_dispatch(self, kind: str = "step") -> None:
        """Stamp a device-program dispatch; device_land() closes the
        device-occupancy span at the readback."""
        if self.trace:
            self._dispatch = (kind, time.monotonic())

    def device_land(self) -> None:
        if not self.trace or self._dispatch is None:
            return
        kind, t0 = self._dispatch
        self._dispatch = None
        self._span("device:" + kind, t0, time.monotonic(), tid=1)

    def instant(self, name: str, detail=None) -> None:
        """Timeline instant (a preemption)."""
        if not self.trace:
            return
        ev = {"name": name, "ph": "i", "s": "p", "pid": 0, "tid": 0,
              "ts": round((time.monotonic() - self._t0) * 1e6, 1)}
        if detail is not None:
            ev["args"] = {"detail": detail}
        self._events.append(ev)

    # export -----------------------------------------------------------

    def export(self) -> dict:
        """Chrome trace-event JSON (perfetto loads `traceEvents`) plus the
        retired requests' event lists and a metrics snapshot."""
        with self._lock:
            meta = [{"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                     "args": {"name": name}}
                    for tid, name in ((0, "host phases"), (1, "device occupancy"))]
            reqs = {str(rid): summary for rid, summary in self._retired}
        return {"traceEvents": meta + list(self._events), "displayTimeUnit": "ms",
                "requests": reqs, "metrics": self.registry.snapshot()}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)
