"""warpsim.obs: unified observability — metrics, tracing, stage profiling.

The port's copy of the reference's observability subsystem, with the
same metric names, header codec and span format, so a fleet that mixes
both packages' daemons and clients reads as one. Stdlib only:

**Metrics registry** — typed :class:`Counter` / :class:`Gauge` /
:class:`Histogram` families with labels, registered on a
:class:`MetricsRegistry` and rendered in the Prometheus text exposition
format (the daemon serves it at ``GET /metrics``). The legacy counter
dicts survive as :class:`CounterView` — a read-only mapping over
registry counters, so ``svc.counters["simulated"]`` and
``stats()["counters"]`` keep their exact shapes while the values live
here. The view is *strict*: incrementing or reading a key that was
never registered raises, which is what keeps the legacy views and the
registry from drifting apart.

**Request tracing** — a per-study trace id with per-hop span ids rides
the existing ``X-Warpsim-Op`` header (``<op>;trace=<id>;span=<id>``;
a bare legacy value still parses as just the op/fault marker, so old
clients interoperate). Finished spans land in a bounded in-memory
:class:`TraceBuffer` ring (``WARPSIM_OBS_RING``, default
:data:`DEFAULT_RING`), dumpable via ``GET /debug/trace?id=...`` — merge
the dumps of every daemon a study touched and the parent links
reconstruct exactly which daemon simulated, served from cache,
peer-forwarded, replicated, or adopted worker results for any cell.
Span ``t0`` values are *monotonic-clock* readings local to one process:
order spans within a process by them, across processes by parentage.

**Stage profiling** — :func:`stage` wraps one cold-path stage
(``trace_build``, ``aggregate``, ``engine``,
``cache_get``/``cache_put``, ``peer_forward``, ``replicate``,
``worker.lease``/``renew``/``complete``): the duration is observed into
the ambient registry's ``warpsim_stage_seconds{stage=...}`` histogram
and, when a trace is active, recorded as a span. Overhead per stage is
one clock read pair plus a dict append under a lock — tens of
microseconds, negligible next to a cell simulation; ``WARPSIM_OBS=0``
reduces every hook to a near-no-op for the paranoid.

The study loop's stages, each once a study or once a family launch,
never once a cell (attributes: the family ``bench/n_threads/seed`` and
the unit count where one applies):

=================  ==========================================  =========
stage              what it times                               once a
=================  ==========================================  =========
``study``          ``api.Session.run``'s whole body (the       study
                   trace's root, :func:`start_trace`)
``result_lookup``  the ResultCache lookups of a sweep          study
``plan``           grouping the misses into families and       study
                   expansion keys, building the payloads
``marshal``        ``_cuda.launch_family``'s ``marshal``       launch
``launch``         K2's enqueue, the result copies and the     launch
                   event record (``marshal`` excluded)
``wait``           ``_cuda.collect``'s wait for the card       launch
``scatter``        a family's records built and written to     launch
                   the ResultCache
=================  ==========================================  =========

``marshal``/``launch``/``wait`` sit in ``_cuda``, so the service's
one-unit launches (``compute_cell`` -> ``simulate`` -> ``run_family``)
report them too.

**K2's device time** — on a card, ``_cuda`` records a pair of timing
events around each K2 launch and reads them once the launch's results
are in (no extra sync). Two families on the ambient registry, made when
the first launch is read (a fresh domain holds only the reference's
names): ``warpsim_k2_seconds{placement}`` (histogram: device seconds a
launch) and ``warpsim_k2_steps_total{placement}`` (counter: the
launches' steps, the longest unit's warp-ops each); their quotient is
K2's seconds a step in each placement (``shared``, ``global``). With
``WARPSIM_OBS=0`` no event is recorded.

**Profiler bridge** — while ``torch.profiler`` records in the calling
thread, every :func:`stage` and every :func:`start_trace` root also opens
``torch.profiler.record_function(name)``, so the program's spans land in
the profiler's trace on the clock of the kernels and copies. This module
imports no torch (a host-engine pool worker holds none): it finds torch
in ``sys.modules``, and a process that never imported it runs no
profiler. With no profiler recording, the check costs a fraction of a
microsecond and no ``record_function`` is made.

Determinism stance: this module reads a monotonic clock — the clock is
injectable (:class:`Observability` takes ``clock=``), only ever measures
durations, and nothing here feeds cache keys or cached records. The
sweep module never calls a clock: it calls :func:`stage`, and the clock
reads happen *here*. Sampling (``WARPSIM_OBS_SAMPLE``) is
likewise deterministic — a hash of the trace id, never an RNG.

Ambient context propagates via :mod:`contextvars`: request handlers and
workers :func:`join_trace`, thread pools re-:func:`activate` a captured
context per task. Everything degrades to a no-op without an active
context, so library code can call :func:`stage` / :func:`event`
unconditionally.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import math
import os
import random
import re
import sys
import threading
import time
from collections import deque
from typing import (
    Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple,
)

from repro_torch.core.warpsim import envcfg

#: The logical-operation header (the reference's convention, which also
#: carries the trace context): ``<op>;trace=<id>;span=<id>``. The op part
#: is the fault-plan marker — stable across retries of one logical
#: operation, which is what keeps marker-keyed injected faults firing
#: once per op while the retries' *spans* still chain into one trace.
OP_HEADER = "X-Warpsim-Op"

ENV_OBS = "WARPSIM_OBS"
ENV_RING = "WARPSIM_OBS_RING"
ENV_SAMPLE = "WARPSIM_OBS_SAMPLE"

#: Default span-ring capacity (finished spans kept per Observability).
DEFAULT_RING = 2048

#: Default histogram buckets, in seconds — tuned for the stack's stage
#: range (sub-millisecond cache probes up to multi-second cold sweeps).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def enabled() -> bool:
    """Live value of the ``WARPSIM_OBS`` kill switch (re-read per call:
    flip it on a running daemon and the next request stops recording)."""
    return envcfg.enabled(ENV_OBS)


# ---------------------------------------------------------------------------
# Metrics: Counter / Gauge / Histogram families on a registry
# ---------------------------------------------------------------------------


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labelnames: Tuple[str, ...],
               labelvalues: Tuple[str, ...]) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + pairs + "}"


class _Child:
    """One (metric family, label values) time series."""

    __slots__ = ("_family", "labelvalues")

    def __init__(self, family: "_Metric", labelvalues: Tuple[str, ...]):
        self._family = family
        self.labelvalues = labelvalues


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self._family.name} cannot decrease (inc {n})")
        with self._family._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._family._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._family._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._value


class _HistogramChild(_Child):
    __slots__ = ("_bucket_counts", "_sum", "_count")

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self._bucket_counts = [0] * (len(family.buckets) + 1)  # + +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._family._lock:
            self._sum += v
            self._count += 1
            for i, bound in enumerate(self._family.buckets):
                if v <= bound:
                    self._bucket_counts[i] += 1
                    break
            else:
                self._bucket_counts[-1] += 1

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        """Observe the duration of the ``with`` body (registry clock)."""
        clock = self._family._clock
        t0 = clock()
        try:
            yield
        finally:
            self.observe(clock() - t0)

    def snapshot(self) -> Dict[str, float]:
        with self._family._lock:
            return {"sum": self._sum, "count": self._count}

    @property
    def count(self) -> int:
        with self._family._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._family._lock:
            return self._sum


class _Metric:
    """A metric family: children keyed by label-value tuples.

    Lock-guarded (one lock per family, shared with its children) so
    concurrent request threads can bump freely; the registry hands every
    family the same injectable clock for :meth:`_HistogramChild.time`.
    """

    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, doc: str, labelnames: Sequence[str],
                 clock: Callable[[], float]):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} on {name}")
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._clock = clock
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def labels(self, **labelvalues: str) -> _Child:
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._child_cls(self, key)
                self._children[key] = child
        return child

    def _default(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}: call "
                f".labels(...) first")
        return self.labels()

    def children(self) -> List[_Child]:
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]


class Counter(_Metric):
    """Monotonically increasing count (rendered with a ``_total`` name)."""

    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Metric):
    """A value that goes up and down (in-flight cells, draining flag)."""

    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Metric):
    """Bucketed distribution (stage/request durations, in seconds)."""

    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, doc, labelnames, clock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"{name}: at least one bucket bound required")
        self.buckets: Tuple[float, ...] = tuple(bounds)
        super().__init__(name, doc, labelnames, clock)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def time(self):
        return self._default().time()


class MetricsRegistry:
    """All metric families of one observability domain (one daemon, one
    client, or the process default).

    ``counter()``/``gauge()``/``histogram()`` are get-or-create and
    idempotent for an identical (kind, labelnames) re-registration —
    re-registering under a different shape raises, so two subsystems
    can't silently share a name they disagree about. `clock` is the
    injectable monotonic source every histogram timer uses.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, doc: str,
                  labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}")
                return existing
            metric = cls(name, doc, labelnames, self._clock, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, doc: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, doc, labelnames)

    def gauge(self, name: str, doc: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, doc, labelnames)

    def histogram(self, name: str, doc: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, doc, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    # ------------------------------------------------------------ render

    def render(self) -> str:
        """The Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            families = [self._metrics[n] for n in sorted(self._metrics)]
        for fam in families:
            lines.append(f"# HELP {fam.name} {fam.doc or fam.name}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for child in fam.children():
                ls = _label_str(fam.labelnames, child.labelvalues)
                if fam.kind == "histogram":
                    with fam._lock:
                        counts = list(child._bucket_counts)
                        total, cnt = child._sum, child._count
                    cum = 0
                    for bound, n in zip(fam.buckets + (math.inf,), counts):
                        cum += n
                        le = _label_str(
                            fam.labelnames + ("le",),
                            child.labelvalues + (_fmt_value(bound),))
                        lines.append(f"{fam.name}_bucket{le} {cum}")
                    lines.append(
                        f"{fam.name}_sum{ls} {_fmt_value(total)}")
                    lines.append(f"{fam.name}_count{ls} {cnt}")
                else:
                    lines.append(
                        f"{fam.name}{ls} {_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Plain-dict view (tests, ``examples/warpsize_study.py``):
        ``{metric: {label-string or "": value}}``; histograms flatten to
        ``sum``/``count`` per label set."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            families = [self._metrics[n] for n in sorted(self._metrics)]
        for fam in families:
            series: Dict[str, float] = {}
            for child in fam.children():
                ls = _label_str(fam.labelnames, child.labelvalues)
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    series[ls + ".sum"] = snap["sum"]
                    series[ls + ".count"] = snap["count"]
                else:
                    series[ls] = child.value
            out[fam.name] = series
        return out


def parse_exposition(text: str) -> Dict[str, float]:
    """Strict-enough parser for the text exposition (smoke/CI checks):
    sample name+labels -> value. Raises ``ValueError`` on a malformed
    line, which is exactly what the CI assertion wants to catch."""
    samples: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value_part = line.rsplit(None, 1)
        except ValueError:
            raise ValueError(f"malformed exposition line: {line!r}")
        bare = name_part.split("{", 1)[0]
        if not _NAME_RE.match(bare):
            raise ValueError(f"bad sample name in line: {line!r}")
        samples[name_part] = (math.inf if value_part == "+Inf"
                              else float(value_part))
    return samples


class CounterView(Mapping):
    """The legacy dict shape, as a read-only mapping over registry
    counters.

    Built from a ``{legacy key: (metric name, help)}`` table; call sites
    keep reading ``view["simulated"]`` / ``dict(view)`` while the value
    lives in a registry :class:`Counter`. Mutation goes through
    :meth:`inc` only, and *unknown keys raise* — a typo'd counter name
    can neither mint a shadow dict entry nor orphan a registry metric,
    which is the guard against counter drift.
    """

    def __init__(self, registry: MetricsRegistry,
                 table: Mapping[str, Tuple[str, str]]):
        self._table = dict(table)
        self._counters: Dict[str, Counter] = {
            key: registry.counter(name, doc)
            for key, (name, doc) in self._table.items()
        }

    def inc(self, key: str, n: float = 1) -> None:
        try:
            self._counters[key].inc(n)
        except KeyError:
            raise KeyError(
                f"counter {key!r} is not in this view's metric table "
                f"(known: {', '.join(sorted(self._counters))})") from None

    def metric_names(self) -> Dict[str, str]:
        """legacy key -> registry metric name (the drift test's map)."""
        return {k: name for k, (name, _doc) in self._table.items()}

    def __getitem__(self, key: str) -> int:
        return int(self._counters[key].value)

    def __iter__(self):
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)


# ---------------------------------------------------------------------------
# Tracing: span ring buffer + ambient context
# ---------------------------------------------------------------------------


class TraceBuffer:
    """Bounded ring of finished spans (dicts; see :func:`span`).

    `maxlen` defaults to ``WARPSIM_OBS_RING`` (read once at
    construction) else :data:`DEFAULT_RING`; the oldest spans fall off,
    so a long-lived daemon holds the most recent traces only —
    ``recorded`` counts lifetime appends so operators can tell "quiet"
    from "evicted"."""

    def __init__(self, maxlen: Optional[int] = None):
        if maxlen is None:
            maxlen = envcfg.get_int(ENV_RING) or DEFAULT_RING
        self.maxlen = int(maxlen)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.maxlen)
        self.recorded = 0

    def record(self, span: Mapping) -> None:
        with self._lock:
            self._spans.append(dict(span))
            self.recorded += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def dump(self, trace_id: Optional[str] = None) -> List[dict]:
        """Spans of one trace (or the whole ring), oldest first."""
        with self._lock:
            spans = list(self._spans)
        if trace_id is None:
            return spans
        return [s for s in spans if s.get("trace") == trace_id]

    def traces(self) -> List[dict]:
        """Per-trace summaries, most recently active first."""
        with self._lock:
            spans = list(self._spans)
        order: List[str] = []
        counts: Dict[str, int] = {}
        roots: Dict[str, str] = {}
        for s in spans:
            tid = s.get("trace")
            if tid not in counts:
                counts[tid] = 0
            counts[tid] += 1
            if tid in order:
                order.remove(tid)
            order.append(tid)
            if s.get("parent") is None:
                roots[tid] = s.get("name", "")
        return [{"trace": tid, "spans": counts[tid],
                 "root": roots.get(tid)} for tid in reversed(order)]


class Observability:
    """One observability domain: a metrics registry + a span ring + the
    clock they share. The daemon owns one (its ``/metrics`` and
    ``/debug/trace`` surfaces), each ResilientClient owns one, and
    plain in-process sweeps share the process :func:`default`."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 ring: Optional[int] = None):
        self.clock = clock
        self.registry = MetricsRegistry(clock=clock)
        self.spans = TraceBuffer(maxlen=ring)
        self.stage_seconds = self.registry.histogram(
            "warpsim_stage_seconds",
            "Duration of one cold-path stage (trace build, aggregate, "
            "timing-engine run, cache/peer/queue hop)",
            labelnames=("stage",))

    def describe(self) -> dict:
        """Ring/recording facts for ``/stats``-style surfaces."""
        return {
            "enabled": enabled(),
            "ring": self.spans.maxlen,
            "spans_held": len(self.spans),
            "spans_recorded": self.spans.recorded,
            "metrics": len(self.registry.names()),
        }


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[Observability] = None


def default() -> Observability:
    """The process-default domain (in-process sweeps, workers, tests)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Observability()
        return _DEFAULT


@dataclasses.dataclass
class TraceContext:
    """The ambient trace position: which trace, which span is current,
    where spans go (`obs`), and whether this trace records at all
    (sampling decided once at the root; non-recording contexts still
    propagate nothing downstream — the whole trace is in or out)."""

    trace_id: str
    span_id: str
    obs: Observability
    recording: bool = True


_CONTEXT: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("warpsim_obs_context", default=None))


def current() -> Optional[TraceContext]:
    """The active trace context of this thread/task, or None."""
    return _CONTEXT.get()


def current_obs() -> Observability:
    """The ambient domain: the active context's, else the default."""
    ctx = _CONTEXT.get()
    return ctx.obs if ctx is not None else default()


# Trace and span ids (16 and 12 hex digits, the reference's shapes) come
# from a generator of this module's, seeded from the OS, and again in a
# forked child. ``uuid4()`` reads ``os.urandom`` for every id: a system
# call of 0.10-0.14 ms a call on an H100 host, paid by every stage of a
# recording trace.
_IDS = random.Random()
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_IDS.seed)


def new_trace_id() -> str:
    return f"{_IDS.getrandbits(64):016x}"


def _new_span_id() -> str:
    return f"{_IDS.getrandbits(48):012x}"


def _sampled(trace_id: str) -> bool:
    """Deterministic sampling: a hash of the trace id against
    ``WARPSIM_OBS_SAMPLE`` — every component that sees the same trace id
    makes the same decision, and no RNG state is involved."""
    try:
        rate = envcfg.get_float(ENV_SAMPLE)
    except ValueError:
        rate = None
    if rate is None:
        rate = 1.0
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    digest = hashlib.sha256(trace_id.encode()).digest()
    return int.from_bytes(digest[:8], "big") < rate * 2.0 ** 64


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Re-enter a captured context in another thread (pool tasks); a
    ``None`` context is a passthrough so call sites don't branch."""
    if ctx is None:
        yield None
        return
    token = _CONTEXT.set(ctx)
    try:
        yield ctx
    finally:
        _CONTEXT.reset(token)


def _record(ctx: TraceContext, name: str, span_id: str,
            parent: Optional[str], t0: float, dur: float,
            attrs: Mapping) -> None:
    rec = {
        "trace": ctx.trace_id, "span": span_id, "parent": parent,
        "name": name, "t0": round(t0, 6), "dur_s": round(dur, 6),
    }
    if attrs:
        rec["attrs"] = {k: v for k, v in attrs.items()}
    ctx.obs.spans.record(rec)


def _profiler_range(name: str):
    """``torch.profiler.record_function(name)``, entered, while the torch
    profiler records in this thread; else None. torch comes from
    ``sys.modules``: this module never imports it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    mark = torch.autograd.profiler.record_function(name)
    mark.__enter__()
    return mark


@contextlib.contextmanager
def start_trace(name: str, obs: Optional[Observability] = None,
                trace_id: Optional[str] = None,
                **attrs) -> Iterator[Optional[TraceContext]]:
    """Begin (or continue) a trace and run the body under its root span.

    Inside an already-active context this degrades to :func:`span` — a
    nested ``Session.run`` inside a daemon request must extend the
    request's trace, not fork a fresh one. Either way the body's duration
    is also observed into ``warpsim_stage_seconds{stage=name}`` (the
    ``study`` stage), with no second span. With ``WARPSIM_OBS=0`` the
    body runs bare (yields None)."""
    if not enabled():
        yield None
        return
    outer = _CONTEXT.get()
    ob = outer.obs if outer is not None else (obs or default())
    mark = _profiler_range(name)
    t0 = ob.clock()
    try:
        if outer is not None:
            with span(name, **attrs) as ctx:
                yield ctx
        else:
            tid = trace_id or new_trace_id()
            ctx = TraceContext(tid, _new_span_id(), ob,
                               recording=_sampled(tid))
            token = _CONTEXT.set(ctx)
            try:
                yield ctx
            finally:
                _CONTEXT.reset(token)
                if ctx.recording:
                    _record(ctx, name, ctx.span_id, None, t0,
                            ob.clock() - t0, attrs)
    finally:
        ob.stage_seconds.labels(stage=name).observe(ob.clock() - t0)
        if mark is not None:
            mark.__exit__(None, None, None)


@contextlib.contextmanager
def bind(obs: Observability) -> Iterator[Optional[TraceContext]]:
    """Bind the ambient *domain* without starting a trace: a
    non-recording context whose only effect is that :func:`stage`
    histograms land in `obs`. The daemon wraps untraced (legacy-client)
    requests in this so its hot-path stage latencies always hit ITS
    ``/metrics`` registry; no spans are recorded and nothing propagates
    downstream."""
    if not enabled():
        yield None
        return
    ctx = TraceContext("", "", obs, recording=False)
    token = _CONTEXT.set(ctx)
    try:
        yield ctx
    finally:
        _CONTEXT.reset(token)


@contextlib.contextmanager
def join_trace(trace_id: Optional[str], name: str,
               obs: Optional[Observability] = None,
               parent: Optional[str] = None,
               **attrs) -> Iterator[Optional[TraceContext]]:
    """Continue a trace started elsewhere: the server side of a
    propagated hop (request handlers) and the worker side of a queue
    job. `parent` is the remote caller's span id (from the header), so
    the merged dumps chain across processes. ``trace_id=None`` (no
    inbound context) is a passthrough."""
    if not trace_id or not enabled():
        yield None
        return
    ob = obs or default()
    ctx = TraceContext(trace_id, _new_span_id(), ob, recording=True)
    t0 = ob.clock()
    token = _CONTEXT.set(ctx)
    try:
        yield ctx
    finally:
        _CONTEXT.reset(token)
        _record(ctx, name, ctx.span_id, parent, t0, ob.clock() - t0, attrs)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[TraceContext]]:
    """A child span under the ambient context (no-op without one).
    Nested spans/stages/events inside the body parent to this span."""
    ctx = _CONTEXT.get()
    if ctx is None or not ctx.recording or not enabled():
        yield None
        return
    child = TraceContext(ctx.trace_id, _new_span_id(), ctx.obs, True)
    t0 = ctx.obs.clock()
    token = _CONTEXT.set(child)
    try:
        yield child
    finally:
        _CONTEXT.reset(token)
        _record(child, name, child.span_id, ctx.span_id, t0,
                ctx.obs.clock() - t0, attrs)


def event(name: str, **attrs) -> None:
    """A zero-duration span (fault injections, per-cell source notes)."""
    ctx = _CONTEXT.get()
    if ctx is None or not ctx.recording or not enabled():
        return
    t0 = ctx.obs.clock()
    _record(ctx, name, _new_span_id(), ctx.span_id, t0, 0.0, attrs)


@contextlib.contextmanager
def stage(name: str, **attrs) -> Iterator[None]:
    """Time one cold-path stage: observe the ambient domain's
    ``warpsim_stage_seconds{stage=name}`` histogram and, when a trace is
    recording, append a span; under a recording torch profiler, also
    mark it in the profiler's trace. This is the only clock the
    determinism modules ever (indirectly) touch — their own source stays
    clock-free and the lint rule keeps it that way."""
    if not enabled():
        yield
        return
    ctx = _CONTEXT.get()
    ob = ctx.obs if ctx is not None else default()
    mark = _profiler_range(name)
    t0 = ob.clock()
    try:
        yield
    finally:
        dur = ob.clock() - t0
        if mark is not None:
            mark.__exit__(None, None, None)
        ob.stage_seconds.labels(stage=name).observe(dur)
        if ctx is not None and ctx.recording:
            _record(ctx, name, _new_span_id(), ctx.span_id, t0, dur, attrs)


# ---------------------------------------------------------------------------
# Header codec (the X-Warpsim-Op convention, extended)
# ---------------------------------------------------------------------------


def format_op_header(op: str, ctx: Optional[TraceContext] = None) -> str:
    """Header value for an outbound hop: the op/fault marker plus the
    trace context when one is recording. The op part must stay stable
    across retries of one logical operation (it is the fault-plan
    marker); the *span* part is the sender's current span, so the
    receiver's span parents correctly even on a retry attempt."""
    parts = [op] if op else []
    if ctx is not None and ctx.recording and enabled():
        parts.append(f"trace={ctx.trace_id}")
        parts.append(f"span={ctx.span_id}")
    return ";".join(parts)


def parse_op_header(value: Optional[str]
                    ) -> Tuple[str, Optional[str], Optional[str]]:
    """``(op, trace_id, span_id)`` from a header value. A bare legacy
    value (no ``trace=``/``span=`` fields) parses as pure op — old
    clients and hand-rolled probes keep working unchanged."""
    if not value:
        return "", None, None
    op_parts: List[str] = []
    tid: Optional[str] = None
    sid: Optional[str] = None
    for part in value.split(";"):
        if part.startswith("trace="):
            tid = part[len("trace="):] or None
        elif part.startswith("span="):
            sid = part[len("span="):] or None
        else:
            op_parts.append(part)
    return ";".join(op_parts), tid, sid


def trace_headers(ctx: Optional[TraceContext] = None) -> Dict[str, str]:
    """Headers for an internal hop (peer forward, replicate, worker
    call) carrying the ambient trace; empty when there is none — the
    receiver then falls back to its method+path fault marker."""
    ctx = ctx if ctx is not None else _CONTEXT.get()
    value = format_op_header("", ctx)
    return {OP_HEADER: value} if value else {}
