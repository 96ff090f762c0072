"""Named timing monitors + process-global dashboard.

PyTorch-port counterpart of ``multiverso_tpu.dashboard``, itself the
equivalent of the reference observability layer
(``include/multiverso/dashboard.h:16-73``, ``src/dashboard.cpp:14-45`` in
the Multiverso reference): named ``Monitor`` timers, latency
``Histogram``s, ``Gauge``s and ``Counter``s registered into a
process-global ``Dashboard`` (displayed at shutdown), and a
``monitor(name)`` context manager.

The instruments are plain host state behind ``threading`` locks. The
device hooks are torch's: ``monitor(..., sync=True)`` calls
``torch.cuda.synchronize`` before the span closes so it covers device
execution, not just the asynchronous launch, and :func:`profile_trace`
wraps ``torch.profiler``.

Windowed latency objectives (:class:`SLO`, ``Dashboard.set_slo``) ride
every ``Dashboard.snapshot()`` as ``SLO_P<p>[<histogram>]`` rows, and
:meth:`Histogram.buckets` exports a window as log-bucket counts on the
JAX package's bucket boundaries, so exports of both packages merge
(:func:`merge_buckets`).

The export surface is the JAX module's (``multiverso_tpu/dashboard.py``
:708-976): :func:`snapshot_deltas` (the one definition of interval
rates, shared with the fleet observability plane),
:func:`render_prometheus` (text byte-identical to JAX's for the same
snapshot) and its inverse :func:`parse_prometheus`, and the periodic
JSON-lines :class:`MetricsExporter` behind ``-metrics_jsonl``.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional


class Timer:
    """Wall-clock start/elapse timer (reference ``util/timer.h:8-24``;
    JAX ``dashboard.py:28``)."""

    def __init__(self) -> None:
        self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def elapse_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


class Monitor:
    """Accumulating named timer (reference ``dashboard.h:26-57``).

    Start timestamps are thread-local so concurrent spans on the same
    monitor name don't clobber each other's begin().
    """

    def __init__(self, name: str, register: bool = True) -> None:
        self.name = name
        self.count = 0
        self.total_ms = 0.0
        self._local = threading.local()
        self._lock = threading.Lock()
        if register:
            Dashboard.add_monitor(self)

    def begin(self) -> None:
        self._local.t0 = time.perf_counter()

    def end(self) -> None:
        t0 = getattr(self._local, "t0", None)
        if t0 is None:
            return
        elapsed = (time.perf_counter() - t0) * 1e3
        self._local.t0 = None
        self.record(elapsed)

    def record(self, elapsed_ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += elapsed_ms

    def average_ms(self) -> float:
        with self._lock:
            return self.total_ms / self.count if self.count else 0.0

    def info_string(self) -> str:
        with self._lock:
            avg = self.total_ms / self.count if self.count else 0.0
            return (
                f"[{self.name}] count = {self.count} total = {self.total_ms:.3f} ms "
                f"avg = {avg:.3f} ms"
            )


# -- mergeable log-bucket export ---------------------------------------------
#
# Bucket i holds samples in (BUCKET_BASE**i, BUCKET_BASE**(i+1)]; a merge
# adds counts per index, and a percentile read off (merged) counts returns
# the containing bucket's geometric midpoint BUCKET_BASE**(i + 0.5), within
# BUCKET_REL_ERROR (~9.05%) of the pooled nearest-rank sample. Samples <= 0
# land in a "zero" bucket below every indexed one and read back as 0.0. The
# base and the index rule are the JAX package's, bit for bit.

BUCKET_BASE = 2 ** 0.25
BUCKET_REL_ERROR = BUCKET_BASE ** 0.5 - 1
_BUCKET_LOG = math.log(BUCKET_BASE)


def bucket_index(value_ms: float) -> Optional[int]:
    """Log-bucket index for one sample (None = the zero bucket)."""
    if value_ms <= 0.0:
        return None
    return math.floor(math.log(value_ms) / _BUCKET_LOG)


def bucket_value(index: int) -> float:
    """The bucket's representative: the geometric midpoint of its edges."""
    return BUCKET_BASE ** (index + 0.5)


def merge_buckets(exports: List[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Sum per-index counts across exports (:meth:`Histogram.buckets`
    dicts; ``None`` entries are skipped). Counts key as strings, the JSON
    wire form."""
    counts: Dict[str, int] = {}
    zero = 0
    count = 0
    for ex in exports:
        if not ex:
            continue
        zero += int(ex.get("zero", 0))
        count += int(ex.get("count", 0))
        for k, n in ex.get("counts", {}).items():
            counts[str(k)] = counts.get(str(k), 0) + int(n)
    return {"base": BUCKET_BASE, "count": count, "zero": zero,
            "counts": counts}


def bucket_percentile(export: Dict[str, Any], p: float) -> float:
    """Nearest-rank percentile over a (possibly merged) bucket export:
    :meth:`Histogram._rank`'s rank walked over cumulative bucket counts,
    returning the containing bucket's midpoint."""
    counts = export.get("counts", {})
    zero = int(export.get("zero", 0))
    n = zero + sum(int(v) for v in counts.values())
    if n == 0:
        return 0.0
    rank = min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))
    if rank < zero:
        return 0.0
    seen = zero
    for idx in sorted(int(k) for k in counts):
        seen += int(counts[str(idx)])
        if rank < seen:
            return bucket_value(idx)
    return bucket_value(max(int(k) for k in counts))   # pragma: no cover


def bucket_breach_frac(export: Dict[str, Any], threshold_ms: float) -> float:
    """Fraction of a bucketed window above ``threshold_ms``: a bucket
    breaches when its midpoint exceeds the threshold, so the answer is
    exact up to the one bucket straddling the target."""
    counts = export.get("counts", {})
    n = int(export.get("zero", 0)) + sum(int(v) for v in counts.values())
    if n == 0:
        return 0.0
    over = sum(int(v) for k, v in counts.items()
               if bucket_value(int(k)) > threshold_ms)
    return over / n


class Histogram:
    """Bounded latency histogram: count/percentiles over a sliding window
    of the most recent ``window`` samples (nearest-rank percentiles)."""

    WINDOW = 65536

    def __init__(self, name: str, window: int = WINDOW,
                 register: bool = True) -> None:
        self.name = name
        self.count = 0                      # lifetime samples
        self._buf = [0.0] * int(window)
        self._n = 0                         # filled slots (<= window)
        self._pos = 0                       # next write slot
        self._lock = threading.Lock()
        if register:
            Dashboard.add_histogram(self)

    def record(self, value_ms: float) -> None:
        with self._lock:
            self.count += 1
            self._buf[self._pos] = float(value_ms)
            self._pos = (self._pos + 1) % len(self._buf)
            self._n = min(self._n + 1, len(self._buf))

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self._n = 0
            self._pos = 0

    def _window(self):
        """(lifetime count, sorted live window); only the copy is locked."""
        with self._lock:
            n = self._n
            count = self.count
            data = (list(self._buf) if n == len(self._buf)
                    else self._buf[:n])
        data.sort()
        return count, data

    @staticmethod
    def _rank(data, p: float) -> float:
        n = len(data)
        return data[min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))]

    def percentiles(self, ps) -> Dict[float, float]:
        _, data = self._window()
        if not data:
            return {p: 0.0 for p in ps}
        return {p: self._rank(data, p) for p in ps}

    def percentile(self, p: float) -> float:
        return self.percentiles((p,))[p]

    def window_stats(self, p: float, threshold_ms: float, window=None):
        """``(window n, pXX, fraction of the window above threshold)`` in
        one sort, or none when ``window`` (an already sorted sample list)
        is given: the SLO's read."""
        data = self._window()[1] if window is None else window
        if not data:
            return 0, 0.0, 0.0
        frac = 1.0 - bisect.bisect_right(data, threshold_ms) / len(data)
        return len(data), self._rank(data, p), frac

    def summary(self) -> Dict[str, float]:
        return self._summarize(*self._window())[0]

    def _summarize(self, count, data):
        """``(summary dict, sorted window)`` from one ``_window()`` read, so
        ``Dashboard.snapshot()`` hands the same samples to the SLO row."""
        if not data:
            return ({"count": count, "p50_ms": 0.0, "p95_ms": 0.0,
                     "p99_ms": 0.0, "mean_ms": 0.0, "max_ms": 0.0}, data)
        return ({"count": count,
                 "p50_ms": self._rank(data, 50),
                 "p95_ms": self._rank(data, 95),
                 "p99_ms": self._rank(data, 99),
                 "mean_ms": sum(data) / len(data),
                 "max_ms": data[-1]}, data)

    def buckets(self) -> Dict[str, Any]:
        """Log-bucket export of the retained window: ``{"base", "count"
        (lifetime), "n" (window), "zero", "counts": {str(index):
        count}}``. One window copy, no sort."""
        with self._lock:
            count = self.count
            data = (list(self._buf) if self._n == len(self._buf)
                    else self._buf[: self._n])
        counts: Dict[str, int] = {}
        zero = 0
        for v in data:
            idx = bucket_index(v)
            if idx is None:
                zero += 1
            else:
                key = str(idx)
                counts[key] = counts.get(key, 0) + 1
        return {"base": BUCKET_BASE, "count": count, "n": len(data),
                "zero": zero, "counts": counts}

    def info_string(self) -> str:
        s = self.summary()
        return (f"[{self.name}] count = {int(s['count'])} "
                f"p50 = {s['p50_ms']:.3f} ms p95 = {s['p95_ms']:.3f} ms "
                f"p99 = {s['p99_ms']:.3f} ms mean = {s['mean_ms']:.3f} ms "
                f"max = {s['max_ms']:.3f} ms")


class Gauge:
    """Last-value instrument: a point-in-time level, not a distribution."""

    def __init__(self, name: str, register: bool = True) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()
        if register:
            Dashboard.add_gauge(self)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def get(self) -> float:
        with self._lock:
            return self._value

    def info_string(self) -> str:
        return f"[{self.name}] value = {self.get():.3f}"


class Counter:
    """Monotonic event counter: things that happened, never un-happen."""

    def __init__(self, name: str, register: bool = True) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()
        if register:
            Dashboard.add_counter(self)

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"Counter {self.name!r}: negative increment {n}")
        with self._lock:
            self._value += n

    def get(self) -> int:
        with self._lock:
            return self._value

    def info_string(self) -> str:
        return f"[{self.name}] total = {self.get()}"


class SLO:
    """Windowed latency objective over a registered :class:`Histogram`:
    "the windowed p<percentile> of ``source`` stays under ``target_ms``".
    ``summary()`` reports the percentile, the fraction of the window over
    the target and the burn rate (that fraction over the error budget
    ``1 - percentile/100``; above 1 the tail eats its budget too fast)."""

    def __init__(self, source: str, target_ms: float,
                 percentile: float = 99.0, register: bool = True) -> None:
        self.source = source
        self.target_ms = float(target_ms)
        self.percentile = float(percentile)
        self.name = f"SLO_P{percentile:g}[{source}]"
        if register:
            Dashboard.add_slo(self)

    def summary(self, window=None) -> Dict[str, float]:
        hist = Dashboard.get_or_create_histogram(self.source)
        n, value, frac = hist.window_stats(self.percentile, self.target_ms,
                                           window=window)
        budget = max(1.0 - self.percentile / 100.0, 1e-9)
        return {
            "target_ms": self.target_ms,
            "percentile": self.percentile,
            "window": n,
            "value_ms": value,
            "breach_frac": frac,
            "burn": frac / budget,
            "ok": 0 if (n and value > self.target_ms) else 1,
        }

    def info_string(self) -> str:
        s = self.summary()
        state = "OK" if s["ok"] else "BURNING"
        return (f"[{self.name}] p{self.percentile:g} = {s['value_ms']:.3f} "
                f"ms target = {self.target_ms:.3f} ms burn = "
                f"{s['burn']:.2f} ({state})")


class Dashboard:
    """Process-global instrument registry (reference ``dashboard.h:16-24``)."""

    _monitors: Dict[str, Monitor] = {}
    _histograms: Dict[str, Histogram] = {}
    _gauges: Dict[str, Gauge] = {}
    _counters: Dict[str, Counter] = {}
    _slos: Dict[str, SLO] = {}
    # running reporter threads (engine watchdogs; anything with
    # .detach()): reset() stops them so a test cannot leak one
    _reporters: List[Any] = []
    _lock = threading.Lock()

    @classmethod
    def add_monitor(cls, mon: Monitor) -> None:
        with cls._lock:
            cls._monitors[mon.name] = mon

    @classmethod
    def add_histogram(cls, hist: Histogram) -> None:
        with cls._lock:
            cls._histograms[hist.name] = hist

    @classmethod
    def add_gauge(cls, gauge: Gauge) -> None:
        with cls._lock:
            cls._gauges[gauge.name] = gauge

    @classmethod
    def add_counter(cls, counter: Counter) -> None:
        with cls._lock:
            cls._counters[counter.name] = counter

    @classmethod
    def add_slo(cls, slo: SLO) -> None:
        with cls._lock:
            cls._slos[slo.name] = slo

    @classmethod
    def set_slo(cls, source: str, target_ms: float,
                percentile: float = 99.0) -> SLO:
        """Declare (or re-target) a latency objective over histogram
        ``source``; its row rides every ``snapshot()``."""
        name = f"SLO_P{percentile:g}[{source}]"
        with cls._lock:
            slo = cls._slos.get(name)
        if slo is None:
            slo = SLO(source, target_ms, percentile)
        else:
            slo.target_ms = float(target_ms)
        return slo

    @classmethod
    def attach_reporter(cls, reporter: Any) -> None:
        """Track a running reporter thread; ``reset()`` detaches and
        stops whatever is still attached."""
        with cls._lock:
            if reporter not in cls._reporters:
                cls._reporters.append(reporter)

    @classmethod
    def detach_reporter(cls, reporter: Any) -> None:
        with cls._lock:
            if reporter in cls._reporters:
                cls._reporters.remove(reporter)

    @classmethod
    def _get_or_create(cls, table: Dict[str, Any], kind, name: str):
        with cls._lock:
            inst = table.get(name)
            if inst is None:
                inst = table[name] = kind(name, register=False)
            return inst

    @classmethod
    def get_or_create(cls, name: str) -> Monitor:
        return cls._get_or_create(cls._monitors, Monitor, name)

    @classmethod
    def get_or_create_histogram(cls, name: str) -> Histogram:
        return cls._get_or_create(cls._histograms, Histogram, name)

    @classmethod
    def get_or_create_gauge(cls, name: str) -> Gauge:
        return cls._get_or_create(cls._gauges, Gauge, name)

    @classmethod
    def get_or_create_counter(cls, name: str) -> Counter:
        return cls._get_or_create(cls._counters, Counter, name)

    @classmethod
    def _all(cls) -> List[Any]:
        with cls._lock:
            return (list(cls._monitors.values())
                    + list(cls._histograms.values())
                    + list(cls._gauges.values())
                    + list(cls._counters.values())
                    + list(cls._slos.values()))

    @classmethod
    def stats(cls, name: str) -> Optional[Dict[str, Any]]:
        """One instrument's state, or None when nothing has that name."""
        with cls._lock:
            mon = cls._monitors.get(name)
            hist = cls._histograms.get(name)
            gauge = cls._gauges.get(name)
            counter = cls._counters.get(name)
            slo = cls._slos.get(name)
        if mon is not None:
            return {"count": mon.count, "total_ms": mon.total_ms,
                    "avg_ms": mon.average_ms()}
        if hist is not None:
            return hist.summary()
        if gauge is not None:
            return {"value": gauge.get()}
        if counter is not None:
            return {"value": counter.get()}
        if slo is not None:
            return slo.summary()
        return None

    @classmethod
    def snapshot(cls) -> Dict[str, Dict[str, Any]]:
        """Every instrument's state as one JSON-serializable dict,
        ``{name: {"type": kind, ...stats}}`` (the JAX dashboard's
        layout)."""
        with cls._lock:
            monitors = list(cls._monitors.values())
            histograms = list(cls._histograms.values())
            gauges = list(cls._gauges.values())
            counters = list(cls._counters.values())
            slos = list(cls._slos.values())
        out: Dict[str, Dict[str, Any]] = {}
        for m in monitors:
            out[m.name] = {"type": "monitor", "count": m.count,
                           "total_ms": m.total_ms, "avg_ms": m.average_ms()}
        windows: Dict[str, list] = {}
        for h in histograms:
            summary, windows[h.name] = h._summarize(*h._window())
            out[h.name] = {"type": "histogram", **summary}
        for g in gauges:
            out[g.name] = {"type": "gauge", "value": g.get()}
        for c in counters:
            out[c.name] = {"type": "counter", "value": c.get()}
        for slo in slos:
            # the source histogram's sorted window: the SLO row describes
            # the same samples as the histogram row
            out[slo.name] = {"type": "slo",
                             **slo.summary(window=windows.get(slo.source))}
        return out

    @classmethod
    def display(cls, emit=None) -> str:
        lines = ["--------------Dashboard--------------"]
        lines += [inst.info_string() for inst in cls._all()]
        text = "\n".join(lines)
        if emit is None:
            from .log import Log
            emit = Log.info
        emit("%s", text)
        return text

    @classmethod
    def reset(cls) -> None:
        """Drop every instrument and stop every attached reporter (outside
        the lock: a reporter may need it to finish its poll)."""
        with cls._lock:
            cls._monitors.clear()
            cls._histograms.clear()
            cls._gauges.clear()
            cls._counters.clear()
            cls._slos.clear()
            reporters = list(cls._reporters)
            cls._reporters.clear()
        for reporter in reporters:
            reporter.detach()


@contextmanager
def monitor(name: str, sync: bool = False) -> Iterator[Monitor]:
    """Span context manager replacing MONITOR_BEGIN/END. With ``sync`` the
    span waits for the CUDA device before it closes, so device time is
    counted (the counterpart of ``jax.block_until_ready``)."""
    mon = Dashboard.get_or_create(name)
    mon.begin()
    try:
        yield mon
    finally:
        if sync:
            import torch

            torch.cuda.synchronize()
        mon.end()


def _wait_for(value: Any) -> None:
    """Block until every CUDA tensor in ``value`` (a tensor, or a dict,
    list or tuple nesting them) has been computed: one wait on each
    tensor's device stream, the counterpart of
    ``jax.block_until_ready``. CPU tensors are ready already."""
    import torch

    devices = set()

    def walk(v: Any) -> None:
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(value)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def monitored_block_until_ready(name: str, value: Any) -> Any:
    """Time a device wait on the tensors of ``value`` under monitor
    ``name`` (JAX ``dashboard.py:663``)."""
    mon = Dashboard.get_or_create(name)
    mon.begin()
    _wait_for(value)
    mon.end()
    return value


@contextmanager
def profile_trace(log_dir: str, name: str = "PROFILE") -> Iterator[Monitor]:
    """Capture a ``torch.profiler`` trace (CPU and CUDA activity) for the
    enclosed span into ``log_dir`` as Chrome trace JSON, while a monitor
    records the span's wall time."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    mon = Dashboard.get_or_create(name)
    mon.begin()
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield mon
    finally:
        prof.__exit__(None, None, None)
        mon.end()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


# -- metrics export ----------------------------------------------------------

# The one definition of which snapshot stats are monotonic, shared by the
# Prometheus renderer (# TYPE counter vs gauge) and the interval deltas of
# the JSON-lines reporter and the fleet plane's reports.
_MONOTONE_STATS = frozenset({
    ("counter", "value"), ("monitor", "count"), ("monitor", "total_ms"),
    ("histogram", "count"),
})


def snapshot_deltas(prev: Optional[Dict[str, Dict[str, Any]]],
                    snap: Dict[str, Dict[str, Any]],
                    dt: Optional[float]) -> Dict[str, Dict[str, float]]:
    """Interval deltas of the monotonic stats between two snapshots
    (JAX ``dashboard.py:708``), shared by :class:`MetricsExporter` and
    ``serving/obs_plane.py``. An instrument whose monotonic stats went
    backwards (reset mid-interval) reports no delta; one absent from
    ``prev`` (or whose type changed) is skipped this interval."""
    if prev is None or not dt or dt <= 0:
        return {}
    deltas: Dict[str, Dict[str, float]] = {}
    for name, row in snap.items():
        last = prev.get(name)
        if last is None or last.get("type") != row.get("type"):
            continue
        kind = row.get("type")
        d: Dict[str, float] = {}
        for field, value in row.items():
            if (kind, field) not in _MONOTONE_STATS:
                continue
            diff = value - last.get(field, 0)
            if diff < 0:
                d = {}
                break               # instrument was reset mid-interval
            d[field] = diff
            d[f"{field}_per_s"] = diff / dt
        if d:
            deltas[name] = d
    return deltas


def _prom_split(name: str):
    """``SERVE_TTFT[lm]`` -> (``serve_ttft``, ``lm``); plain names pass
    through with no instance label."""
    instance = None
    base = name
    if name.endswith("]") and "[" in name:
        base, _, rest = name.partition("[")
        instance = rest[:-1]
    metric = re.sub(r"[^a-zA-Z0-9_]", "_", base.lower()).strip("_")
    return metric or "unnamed", instance


def _prom_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _prom_format(value: Any) -> str:
    # repr() floats round-trip exactly through float()
    return repr(float(value)) if isinstance(value, float) else str(value)


def render_prometheus(snapshot: Optional[Dict[str, Dict[str, Any]]] = None,
                      labels: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text exposition of a :meth:`Dashboard.snapshot` (JAX
    ``dashboard.py:769``, the same text for the same snapshot).

    One sample per (instrument, stat field), e.g.
    ``mv_serve_ttft_p50_ms{name="SERVE_TTFT[lm]",instance="lm"} 1.25``;
    the full instrument name rides the ``name`` label, so the mapping is
    lossless. Monotonic stats are ``# TYPE counter``, the rest gauges.
    ``labels`` appends fixed labels to every sample (the fleet plane's
    ``node``)."""
    snap = Dashboard.snapshot() if snapshot is None else snapshot
    extra = "".join(f',{k}="{_prom_escape(str(v))}"'
                    for k, v in sorted((labels or {}).items()))
    families: Dict[str, List[str]] = {}
    family_type: Dict[str, str] = {}
    for name in sorted(snap):
        row = dict(snap[name])
        kind = row.pop("type", "gauge")
        metric, instance = _prom_split(name)
        for field in sorted(row):
            value = row[field]
            if not isinstance(value, (int, float)) or isinstance(value,
                                                                 bool):
                continue            # wire-merged rows may carry strings
            full = (f"mv_{metric}" if field == "value"
                    else f"mv_{metric}_{field}")
            monotone = (kind, field) in _MONOTONE_STATS
            sample_labels = f'name="{_prom_escape(name)}"'
            if instance is not None:
                sample_labels += f',instance="{_prom_escape(instance)}"'
            sample_labels += extra
            family_type.setdefault(full,
                                   "counter" if monotone else "gauge")
            families.setdefault(full, []).append(
                f"{full}{{{sample_labels}}} {_prom_format(value)}")
    lines: List[str] = []
    for full in sorted(families):
        lines.append(f"# TYPE {full} {family_type[full]}")
        lines.extend(families[full])
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> Dict[str, Dict[str, float]]:
    """Inverse of :func:`render_prometheus` keyed by the ``name`` label:
    ``{instrument_name: {sample_name: value}}`` (extra labels such as
    ``node`` are tolerated)."""
    out: Dict[str, Dict[str, float]] = {}
    sample = re.compile(r'^(\w+)\{name="((?:[^"\\]|\\.)*)"[^}]*\} (\S+)$')
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = sample.match(line)
        if not m:
            continue
        full, name, value = m.groups()
        # unescape left to right
        name = re.sub(r"\\(.)",
                      lambda g: {"n": "\n"}.get(g.group(1), g.group(1)),
                      name)
        out.setdefault(name, {})[full] = float(value)
    return out


class MetricsExporter:
    """Periodic metrics reporter: snapshot -> JSON-lines sink + deltas
    (JAX ``dashboard.py:839``).

    Every ``interval_s`` (and on :meth:`stop`) it takes one
    ``Dashboard.snapshot()`` and appends one JSON line ``{"ts",
    "interval_s", "snapshot", "deltas"}``; the deltas are
    :func:`snapshot_deltas` over the monotonic clock. :meth:`prometheus`
    renders the last reported snapshot, so both sinks see the same
    values."""

    _MONOTONE = _MONOTONE_STATS

    def __init__(self, interval_s: float = 10.0, sink: Any = None,
                 emit=None) -> None:
        self.interval_s = float(interval_s)
        self._sink_path = sink if isinstance(sink, str) else None
        self._sink_file = sink if sink is not None and not isinstance(
            sink, str) else None
        self._emit = emit
        self._last: Optional[Dict[str, Dict[str, Any]]] = None
        self._last_ts: Optional[float] = None
        self._last_mono: Optional[float] = None
        # serializes snapshot+commit pairs across concurrent report_once
        # calls; _lock covers only the last-snapshot state, so scrapes
        # and stop() never wait behind a registry sweep
        self._report_lock = threading.Lock()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reports = 0

    def _deltas(self, snap: Dict[str, Dict[str, Any]],
                dt: Optional[float]) -> Dict[str, Dict[str, float]]:
        return snapshot_deltas(self._last, snap, dt)

    def report_once(self) -> dict:
        """Take one snapshot, compute interval deltas, write one line (the
        sink write runs outside both locks)."""
        with self._report_lock:
            snap = Dashboard.snapshot()
            now = time.time()
            mono = time.monotonic()
            with self._lock:
                dt = ((mono - self._last_mono)
                      if self._last_mono is not None else None)
                record = {"ts": now, "interval_s": dt, "snapshot": snap,
                          "deltas": self._deltas(snap, dt)}
                self._last, self._last_ts = snap, now
                self._last_mono = mono
                self.reports += 1
        line = json.dumps(record)
        if self._sink_path is not None:
            with open(self._sink_path, "a") as f:
                f.write(line + "\n")
        elif self._sink_file is not None:
            self._sink_file.write(line + "\n")
        if self._emit is not None:
            self._emit(line)
        return record

    def prometheus(self) -> str:
        """Text exposition of the last reported snapshot, or a fresh one
        before any report."""
        with self._lock:
            snap = self._last
        return render_prometheus(snap)

    def start(self) -> "MetricsExporter":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="mv-metrics", daemon=True)
        self._thread.start()
        Dashboard.attach_reporter(self)
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.report_once()
            except Exception as exc:    # pragma: no cover - sink errors
                from .log import Log
                Log.error("metrics exporter: report failed: %s", exc)

    def detach(self) -> None:
        """``Dashboard.reset()`` hook: stop without a final report (the
        instruments were just cleared)."""
        self.stop(final_report=False)

    def stop(self, final_report: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        Dashboard.detach_reporter(self)
        if final_report:
            try:
                self.report_once()
            except Exception as exc:
                # a dead sink at shutdown must not abort the teardown
                from .log import Log
                Log.error("metrics exporter: final report failed: %s", exc)
