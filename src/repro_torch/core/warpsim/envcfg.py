"""The environment variables the port's service stack reads, in one table.

A copy of the reference's registry restricted to the names the port
reads: the backend choice, the daemon URLs, the mesh, the fault plan and
the observability switches, with the reference's names, defaults and
docs, so one environment configures a fleet that mixes both packages.
Every read goes through the accessors below.

The reference's kill switches of its C core and of its device engine
have no counterpart here: the port has no fallback engine, so nothing
can hide the card or the kernel behind another path. The entry points
take ``device=`` and ``engine=`` instead.

Reads are live (no caching): a test or a daemon that changes the
environment sees the change at the next read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

#: Values that switch an enabled-by-default feature off (the reference's
#: spellings, deliberately not including "false").
DISABLED_VALUES: Tuple[str, ...] = ("0", "no", "off")


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One registered variable: its name, default, and operator docs."""

    name: str
    default: Optional[str]
    doc: str


#: Every WARPSIM_* variable the port reads, with the reference's default
#: and doc.
VARIABLES: Tuple[EnvVar, ...] = (
    EnvVar("WARPSIM_BACKEND", None,
           "Force the Session backend: inprocess | service | queue. "
           "Forced remote backends fail loudly when no daemon is live."),
    EnvVar("WARPSIM_SERVICE_URL", None,
           "Single sweep-daemon URL; clients get a plain SweepClient "
           "(legacy, superseded by WARPSIM_SERVICE_URLS)."),
    EnvVar("WARPSIM_SERVICE_URLS", None,
           "Comma-separated daemon fleet; clients get a ResilientClient "
           "(retry + backoff + failover + circuit breaker)."),
    EnvVar("WARPSIM_PEERS", "",
           "Comma-separated peer URLs: federate daemons into a mesh over "
           "disjoint cache roots (rendezvous-hash ownership, "
           "read-through, replication)."),
    EnvVar("WARPSIM_SELF_URL", "",
           "This daemon's own peer-visible URL; required whenever "
           "WARPSIM_PEERS is set (or pass --advertise-url)."),
    EnvVar("WARPSIM_REPLICATION", None,
           "Copies of each cell/queue-job across the mesh, owner "
           "included (default 2)."),
    EnvVar("WARPSIM_FAULTS", None,
           "Deterministic fault-injection plan for chaos tests; grammar "
           "and the known fault points live in warpsim.faults "
           "(KNOWN_POINTS)."),
    EnvVar("WARPSIM_OBS", "1",
           "Kill switch for the observability subsystem (warpsim.obs): "
           "0|no|off turns span recording, stage histograms, and trace "
           "header propagation into near-no-ops. Metrics counters keep "
           "counting (the legacy stats() views are backed by them). "
           "Re-read per call."),
    EnvVar("WARPSIM_OBS_RING", None,
           "Capacity of the in-memory span ring buffer behind GET "
           "/debug/trace (finished spans per daemon/process; default "
           "2048). Oldest spans are evicted first; read once at "
           "Observability construction."),
    EnvVar("WARPSIM_OBS_SAMPLE", None,
           "Trace sampling rate in [0,1] (default 1.0 = record every "
           "trace). Deterministic per trace id — a hash, not an RNG — so "
           "every daemon a study touches makes the same keep/drop "
           "decision. Stage histograms are never sampled."),
)

# Name -> EnvVar lookup for the accessors.
REGISTRY: Dict[str, EnvVar] = {v.name: v for v in VARIABLES}  # guarded-by: frozen


def get(name: str) -> Optional[str]:
    """The live value of a *registered* variable (else its default).

    Unregistered names raise ``KeyError``.
    """
    try:
        var = REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name!r} is not a registered warpsim env var of the port "
            f"(known: {', '.join(sorted(REGISTRY))})") from None
    return os.environ.get(var.name, var.default)


def enabled(name: str) -> bool:
    """True unless the variable is set to one of :data:`DISABLED_VALUES`."""
    return (get(name) or "") not in DISABLED_VALUES


def get_int(name: str) -> Optional[int]:
    """Integer value of a registered variable, or None when unset/empty."""
    raw = get(name)
    if raw is None or not str(raw).strip():
        return None
    return int(raw)


def get_float(name: str) -> Optional[float]:
    """Float value of a registered variable, or None when unset/empty."""
    raw = get(name)
    if raw is None or not str(raw).strip():
        return None
    return float(raw)


def describe() -> Dict[str, Dict[str, Optional[str]]]:
    """The full table (name -> default/doc), for /stats-style surfaces."""
    return {v.name: {"default": v.default, "doc": v.doc} for v in VARIABLES}
