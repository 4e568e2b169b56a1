"""Deterministic fault injection + typed service errors.

The port's copy of the reference's robustness substrate for the serving
stack, with the same grammar and fault points: a seeded,
schedule-driven :class:`FaultPlan` that the daemon, the resilient
client, and the queue worker consult at named *fault points*, plus the
typed exceptions (:class:`ServiceError` / :class:`ServiceUnavailable`)
that replace raw ``urllib`` errors at every HTTP boundary.

Fault points (a rule's ``point`` is an ``fnmatch`` pattern over these):

    ``server/<path>``    before a request is handled (e.g. ``server/study``,
                         ``server/queue/lease``) — actions: ``drop`` (close
                         the socket with no response), ``error=CODE`` (send
                         an HTTP error), ``delay=SECONDS``, ``kill`` (the
                         daemon plays dead from now on)
    ``response/<path>``  after handling: compute, mutate state, then drop
                         the response on the floor (lost-ack scenario)
    ``service.cell``     per *simulated* cell, marker = the cell key;
                         ``kill`` here is "daemon dies after N cells"
    ``worker.lease`` / ``worker.renew`` / ``worker.complete``
                         in :func:`work_queue.run_worker` around each HTTP
                         call — ``drop`` (simulated connection loss) or
                         ``corrupt`` (mangle the POST body; the server
                         rejects it and the worker must retry cleanly)
    ``client.request``   in :class:`service.ResilientClient` before an
                         attempt leaves the process
    ``peer.forward``     in a mesh daemon before a cell read-through
                         leaves for a peer (marker ``<key>@<url>``; the
                         job-adoption scan uses ``job:<id>@<url>``) —
                         *any* fired action makes that peer look
                         unreachable, so the requester walks on to the
                         next candidate or simulates locally
    ``peer.replicate``   before a cell/job replica is pushed to a
                         successor (marker ``<key>@<url>`` /
                         ``job:<id>@<url>``) — fired means the replica
                         is dropped and counted ``replica_send_failures``

Plans are **marker-keyed**: each rule remembers every marker (operation
id / cell key) it has already decided on, so a *retried* operation never
re-fails — exactly the property a retry layer needs to be testable.
Scheduling is deterministic: ``after=N`` skips the first N distinct
markers, ``times=K`` fires on at most K markers (``times=inf`` for
unlimited), and ``p=F`` consults a ``random.Random(seed)`` so even
probabilistic plans replay identically.

Spec grammar (``WARPSIM_FAULTS`` env var or ``FaultPlan.from_spec``)::

    spec    := segment (';' segment)*
    segment := 'seed=' INT | point ':' action (',' opt)*
    action  := 'drop' | 'kill' | 'corrupt' | 'error' ['=' CODE]
             | 'delay' ['=' SECONDS]
    opt     := 'after=' INT | 'times=' (INT | 'inf') | 'p=' FLOAT

Example: ``server/study:error=503,times=2;service.cell:kill,after=5``.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import threading
from typing import Dict, List, Optional, Sequence

from repro_torch.core.warpsim import envcfg
from repro_torch.core.warpsim import obs as obs_mod

ENV_FAULTS = "WARPSIM_FAULTS"

ACTIONS = ("drop", "kill", "corrupt", "error", "delay")

#: Every fault point the stack consults, pattern -> one-line doc. This is
#: the registry behind the ``WARPSIM_FAULTS`` grammar above: a ``point``
#: in a spec only ever matches operations that flow through one of these,
#: and every ``fault_point(...)`` call site is validated against it — at
#: runtime by :func:`fault_point`, statically by the ``fault-registry``
#: rule of the reference's warpsim-lint, which checks the port's
#: literal points against the reference's registry. Chaos plans therefore cannot
#: silently drift from the points the daemons actually check:
#: registering a new point here (with its docstring entry above) is the
#: only way to add one.
KNOWN_POINTS: Dict[str, str] = {  # guarded-by: frozen
    "server/*": "daemon, before a request to <path> is handled",
    "response/*": "daemon, after handling <path>: drop the response",
    "service.cell": "daemon, per simulated cell (marker = cell key)",
    "worker.lease": "work_queue.run_worker, around the lease call",
    "worker.renew": "work_queue.run_worker, around the renew call",
    "worker.complete": "work_queue.run_worker, around the complete call",
    "client.request": "ResilientClient, before an attempt leaves",
    "peer.forward": "mesh daemon, before a cell/job read-through",
    "peer.replicate": "mesh daemon, before a replica push",
}


def fault_point(point: str) -> str:
    """Validate ``point`` against :data:`KNOWN_POINTS` and return it.

    Every ``FaultPlan.check`` call site names its point through this
    helper, so a typo'd or unregistered point fails the *instrumented
    code* immediately instead of silently never matching any chaos plan.
    Dynamic points (``"server" + path``, ``f"worker.{kind}"``) are
    validated here at runtime; literal points are additionally checked
    statically by warpsim-lint.
    """
    for pattern in KNOWN_POINTS:
        if point == pattern or fnmatch.fnmatchcase(point, pattern):
            return point
    raise ValueError(
        f"unknown fault point {point!r}: register it in "
        f"faults.KNOWN_POINTS (known: {', '.join(sorted(KNOWN_POINTS))})")


class ServiceError(RuntimeError):
    """An HTTP request to a warpsim daemon failed with a definite status.

    Carries enough context for callers (and post-mortems) to act without
    parsing the message: the endpoint ``url``, the request ``path``, the
    HTTP ``code`` (``None`` when no response arrived), and how many
    ``attempts`` were made before the error escaped.
    """

    def __init__(self, message: str, *, url: Optional[str] = None,
                 path: Optional[str] = None, code: Optional[int] = None,
                 attempts: int = 1):
        super().__init__(message)
        self.url = url
        self.path = path
        self.code = code
        self.attempts = attempts

    @property
    def is_transient(self) -> bool:
        """Whether a retry could plausibly succeed (5xx or no response).

        4xx responses mean the *request* is wrong — retrying the same
        bytes is useless and hides bugs, so they are not transient.
        """
        return self.code is None or self.code >= 500


class ServiceUnavailable(ServiceError):
    """No usable response at all: connection refused/reset, timeout,
    undecodable body, or every endpoint circuit-open/exhausted."""


class FaultError(RuntimeError):
    """Raised inside the daemon when an injected fault fires mid-work
    (e.g. ``service.cell`` ``kill``). Never escapes to real clients —
    the handler turns it into a dropped connection or 500."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One schedule entry: fire ``action`` at markers matching ``point``.

    ``after`` skips the first N *distinct* markers seen at this point,
    ``times`` caps how many markers fire (-1 = unlimited), ``p`` gates
    each firing on the plan's seeded RNG.
    """

    point: str
    action: str
    code: int = 503          # for action == "error"
    delay_s: float = 0.05    # for action == "delay"
    after: int = 0
    times: int = 1
    p: float = 1.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {ACTIONS})")


@dataclasses.dataclass(frozen=True)
class Fault:
    """A fired fault, returned by :meth:`FaultPlan.check`."""

    point: str
    action: str
    code: int
    delay_s: float
    rule_index: int


class _RuleState:
    __slots__ = ("seen", "fired", "auto_seq")

    def __init__(self):
        self.seen = set()
        self.fired = 0
        self.auto_seq = 0


class FaultPlan:
    """A seeded, marker-keyed fault schedule shared by one component.

    Thread-safe. Markers are remembered per rule, so a marker a rule has
    already decided on (fired or passed) is never re-decided — retries of
    the same logical operation sail through. Marker sets grow with the
    number of distinct operations checked; plans are test/chaos tooling,
    not a production dependency, so this is deliberate.
    """

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.rules: List[FaultRule] = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._state = [_RuleState() for _ in self.rules]
        self._lock = threading.Lock()
        self.checks = 0
        self.fired: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def check(self, point: str, marker: Optional[str] = None) -> Optional[Fault]:
        """Decide whether a fault fires at ``point`` for ``marker``.

        ``marker`` identifies the logical operation (cell key, client op
        id); ``None`` mints a fresh auto-marker, i.e. every check counts
        as a new distinct operation. Returns the fired :class:`Fault` or
        ``None``. First matching rule that fires wins; matching rules
        that decide "pass" still record the marker (their schedule keeps
        counting) but do not block later rules.
        """
        with self._lock:
            self.checks += 1
            for i, rule in enumerate(self.rules):
                if not fnmatch.fnmatchcase(point, rule.point):
                    continue
                state = self._state[i]
                if marker is None:
                    key = ("#auto", state.auto_seq)
                    state.auto_seq += 1
                else:
                    key = marker
                if key in state.seen:
                    continue  # retried operation: never re-fail
                position = len(state.seen)
                state.seen.add(key)
                if position < rule.after:
                    continue
                if rule.times >= 0 and state.fired >= rule.times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                state.fired += 1
                self.fired[point] = self.fired.get(point, 0) + 1
                # Every injected fault is a trace event: chaos runs read
                # which hop of which study a fault actually hit straight
                # out of /debug/trace. No-op without an active trace.
                obs_mod.event("fault", point=point, action=rule.action)
                return Fault(point=point, action=rule.action, code=rule.code,
                             delay_s=rule.delay_s, rule_index=i)
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "checks": self.checks,
                "fired": dict(self.fired),
                "rules": [dataclasses.asdict(r) for r in self.rules],
            }

    # ------------------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``WARPSIM_FAULTS`` grammar (see module docstring)."""
        rules: List[FaultRule] = []
        for raw in spec.split(";"):
            segment = raw.strip()
            if not segment:
                continue
            if ":" not in segment:
                if segment.startswith("seed="):
                    seed = int(segment[len("seed="):])
                    continue
                raise ValueError(
                    f"bad fault segment {segment!r}: expected "
                    f"'point:action[,opt]*' or 'seed=N'")
            point, _, rest = segment.partition(":")
            tokens = [t.strip() for t in rest.split(",") if t.strip()]
            if not tokens:
                raise ValueError(f"fault segment {segment!r} has no action")
            name, _, value = tokens[0].partition("=")
            kwargs: dict = {}
            if name == "error":
                kwargs["code"] = int(value) if value else 503
            elif name == "delay":
                kwargs["delay_s"] = float(value) if value else 0.05
            elif value:
                raise ValueError(
                    f"fault action {name!r} takes no value (got {value!r})")
            for token in tokens[1:]:
                opt, _, val = token.partition("=")
                if opt == "after":
                    kwargs["after"] = int(val)
                elif opt == "times":
                    kwargs["times"] = -1 if val in ("inf", "-1") else int(val)
                elif opt == "p":
                    kwargs["p"] = float(val)
                else:
                    raise ValueError(
                        f"unknown fault option {token!r} in {segment!r}")
            rules.append(FaultRule(point=point.strip(), action=name, **kwargs))
        return cls(rules, seed=seed)

    @classmethod
    def from_env(cls, var: str = ENV_FAULTS) -> Optional["FaultPlan"]:
        """Plan from ``$WARPSIM_FAULTS``, or ``None`` when unset/empty.

        `var` must be a ``WARPSIM_*`` name registered in
        :mod:`repro_torch.core.warpsim.envcfg` — the read goes through the
        registry, which raises ``KeyError`` for unregistered names
        rather than silently returning ``None``.
        """
        spec = envcfg.get(var)
        if not spec or not spec.strip():
            return None
        return cls.from_spec(spec)
