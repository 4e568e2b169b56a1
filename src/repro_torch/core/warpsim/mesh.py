"""Federated daemon mesh: who owns a cell, and where its replicas live.

The port's copy of the reference's mesh. The rankings are the
reference's, byte for byte (the same SHA-256 weights over the same
strings), so a fleet that mixes both packages' daemons agrees on every
owner and replica. Daemons learn their peers from
``$WARPSIM_PEERS`` and agree — with no coordinator, no gossip, and no
shared state — on which daemon *owns* each cell via rendezvous
(highest-random-weight) hashing over the cell key:

* every member ranks each key by ``sha256("<member-url>|<key>")``;
* the highest-ranked member is the **owner** (on a local miss, other
  members read-through to it with ``GET /peer/cell`` before simulating);
* the next ``replication - 1`` members are the **replica successors**
  (the owner pushes completed cells to them with ``POST
  /peer/replicate``), so any single daemon — and its disk — can vanish
  without losing coverage.

Rendezvous hashing is used instead of a token ring because membership
here is a handful of static URLs: it needs no virtual nodes to balance,
and removing one member only reassigns *that member's* keys (the
relative order of the survivors is untouched), which is exactly the
failover property the mesh leans on — when the owner is unreachable the
requester walks the same ranking to the replicas, and the keys never
move wholesale.

Queue jobs use the same ranking over the job id: every job snapshot is
replicated to its successors (``POST /peer/job``), and a daemon asked
about a job it never minted adopts it from its replica table or its
peers (``GET /peer/job``) — cross-daemon job visibility without the
shared ``queue/`` directory.

The mesh is a *performance and durability* layer, never a correctness
dependency: cells are deterministic and content-addressed, so any
member can always degrade to local simulation (dead peer, partition,
draining peer, key-version skew) and the records stay bit-identical —
the only cost is bounded duplicate work.

Configuration (see :meth:`MeshConfig.from_env`)::

    WARPSIM_PEERS=http://a:8321,http://b:8321,http://c:8321
    WARPSIM_SELF_URL=http://a:8321     # this daemon's own peer-visible URL
    WARPSIM_REPLICATION=2              # copies per cell/job (default 2)
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.warpsim import envcfg

ENV_PEERS = "WARPSIM_PEERS"
ENV_SELF = "WARPSIM_SELF_URL"
ENV_REPLICATION = "WARPSIM_REPLICATION"

DEFAULT_REPLICATION = 2


def _norm_url(url: str) -> str:
    return url.strip().rstrip("/")


def rendezvous_ranking(key: str, members: Sequence[str]) -> List[str]:
    """Members ranked highest-weight-first for `key`.

    Weight is ``sha256("<member>|<key>")`` — deterministic across
    processes and Python versions (no ``hash()`` randomization), and
    independent per member, which is what gives rendezvous hashing its
    monotone-membership property: dropping a member never reorders the
    survivors. The member URL is the tiebreaker so the ranking is total
    even in the (astronomically unlikely) digest-collision case.
    """
    return sorted(
        members,
        key=lambda m: (hashlib.sha256(f"{m}|{key}".encode()).digest(), m),
        reverse=True)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """One daemon's view of the mesh: itself, its peers, the replica count.

    `peers` never contains `self_url`; `members` is the full agreed-upon
    membership (identical on every daemon as long as they were handed
    the same URL list — the only operator obligation). `replication` is
    the total number of copies of a cell/job (owner included), capped at
    the member count.
    """

    self_url: str
    peers: Tuple[str, ...]
    replication: int = DEFAULT_REPLICATION
    peer_timeout: float = 60.0

    def __post_init__(self):
        if not self.self_url:
            raise ValueError("mesh needs this daemon's own URL "
                             f"(set ${ENV_SELF} or pass self_url)")
        if self.replication < 1:
            raise ValueError(f"replication must be >= 1, "
                             f"got {self.replication}")

    @classmethod
    def build(cls, self_url: str, peers: Sequence[str],
              replication: Optional[int] = None,
              peer_timeout: float = 60.0) -> "MeshConfig":
        """Normalized config: URLs stripped of trailing slashes, peers
        deduplicated order-preserving with `self_url` removed."""
        me = _norm_url(self_url)
        out: List[str] = []
        for p in peers:
            p = _norm_url(p)
            if p and p != me and p not in out:
                out.append(p)
        return cls(self_url=me, peers=tuple(out),
                   replication=(DEFAULT_REPLICATION if replication is None
                                else int(replication)),
                   peer_timeout=peer_timeout)

    @classmethod
    def from_env(cls, self_url: Optional[str] = None
                 ) -> Optional["MeshConfig"]:
        """Config from ``$WARPSIM_PEERS`` / ``$WARPSIM_SELF_URL`` /
        ``$WARPSIM_REPLICATION``; None when no peers are configured.

        Raises when peers are named but this daemon's own URL is not
        (neither argument nor env): a mesh member that can't identify
        itself in the ranking would silently forward work it owns, so a
        half-configured mesh fails loudly instead.
        """
        peers = envcfg.get(ENV_PEERS) or ""
        peer_list = [p for p in (s.strip() for s in peers.split(","))
                     if p]
        if not peer_list:
            return None
        me = self_url or envcfg.get(ENV_SELF) or ""
        if not _norm_url(me):
            raise ValueError(
                f"${ENV_PEERS} is set but this daemon's own URL is "
                f"unknown — set ${ENV_SELF} (or pass --advertise-url)")
        return cls.build(me, peer_list,
                         replication=envcfg.get_int(ENV_REPLICATION))

    # ------------------------------------------------------------ ranking

    @property
    def members(self) -> Tuple[str, ...]:
        return (self.self_url,) + self.peers

    def ranking(self, key: str) -> List[str]:
        return rendezvous_ranking(key, self.members)

    def owner(self, key: str) -> str:
        return self.ranking(key)[0]

    def targets(self, key: str) -> List[str]:
        """The `replication` members that should hold a copy of `key`
        (owner first, then its successors)."""
        return self.ranking(key)[:min(self.replication, len(self.members))]

    def fetch_order(self, key: str) -> List[str]:
        """Peers to ask for `key` on a local miss, best-first: the owner,
        then the replica successors — never this daemon itself. Empty
        when this daemon is the owner (it should just simulate)."""
        targets = self.targets(key)
        if targets and targets[0] == self.self_url:
            return []
        return [t for t in targets if t != self.self_url]

    def replica_targets(self, key: str) -> List[str]:
        """Where this daemon pushes a copy of `key` after computing it."""
        return [t for t in self.targets(key) if t != self.self_url]

    def job_targets(self, job: str) -> List[str]:
        """Peers that hold a replica of job `job`'s snapshot (same
        rendezvous ranking, hashed over the job id)."""
        return [t for t in rendezvous_ranking(job, self.members)
                [:min(self.replication, len(self.members))]
                if t != self.self_url]

    def describe(self) -> dict:
        return {"self": self.self_url, "peers": list(self.peers),
                "replication": self.replication}
