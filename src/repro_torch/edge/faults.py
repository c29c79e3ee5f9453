"""Fault injection and graceful degradation for the edge plane.

The scatter-gather plane retired the computing center from the read
path: every rule-3 query is answered from peer-exchanged border rows
over metro links. That wins latency only while every edge server and
peer link is up — this module models the failure half of the
deployment so the serving stack can be *tested* under partial failure
instead of assumed healthy:

* ``FaultPlan`` — a frozen, seedable description of what goes wrong:
  peer-link drop / per-attempt timeout / slow link, edge-server outage
  (explicit districts, a flap period, or a rate), and center
  unreachability, plus the degradation knobs (bounded retry count,
  exponential backoff, link timeout charge).
* ``FaultInjector`` — the deterministic runtime: every draw is a
  stateless ``np.random.default_rng((seed, epoch, kind, *key))``
  sample, so an outcome depends only on the plan and the draw's
  coordinates — never on wall-clock time, global RNG state, or how
  many unrelated draws ran first.  Two runs of the same workload under
  the same plan replay **byte-for-byte**, here and in the JAX
  package's ``repro.edge.faults`` (this module is its copy: the draw
  coordinates and their order are the same, so a plan replays the same
  bytes in either package); a logged seed is a full repro.

The degradation ladder the consumers implement (scatter plane,
simulator, load generator) — degrade, never error, never lie:

1. peer exchange with bounded retry + exponential backoff
   (``link_trial`` / ``exchange``);
2. on link failure, fall back from the scatter placement to the
   forwarded-path (center) route — still exact for rule-3 lanes, the
   ``degraded_reason`` records the reroute;
3. when a district of a cross pair is dark, serve rule 3 from the
   surviving min (the target district's server owns the lane after an
   (s, t) swap — bit-identical by symmetry of the §4.2 min);
4. when the exchange AND the center are unreachable, serve the
   previous-generation border rows the server still holds — flagged
   ``exactness="stale"``;
5. same-district lanes of a dark district get the center's
   ``min_b B[s,b] + B[t,b]`` — a certified **upper** bound (triangle
   inequality over real paths), flagged stale;
6. only when nothing is reachable does the answer become +inf — still
   flagged, so no silent wrong answer is possible at any fault rate.

Select it end to end with ``ServingPolicy(engine="scatter_gather",
faults=FaultPlan(...))``; availability scenarios for the §5 simulator
and the open-loop load harness are built by ``link_loss_sweep`` and
``district_outage_storm``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

# draw-kind coordinates (part of every RNG key; never reorder — replay
# stability across code motion is the point of keying draws explicitly)
KIND_LINK_DROP = 1
KIND_LINK_TIMEOUT = 2
KIND_LINK_SLOW = 3
KIND_SERVER = 4
KIND_CENTER = 5
KIND_STORM = 6
KIND_LOADGEN = 7

_RATE_FIELDS = ("peer_drop_rate", "peer_timeout_rate", "peer_slow_rate",
                "server_outage_rate", "center_outage_rate")


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic failure schedule + degradation knobs.

    All randomness in a chaos run derives from ``seed`` alone (the
    injector draws stateless per-event samples keyed on it), so a plan
    IS its replay: log the plan, rerun the workload, get the same bytes.

    * ``peer_drop_rate`` — probability a peer link is down for a whole
      injector epoch (retries cannot heal it; the consumer falls
      through to the forwarded/stale ladder).
    * ``peer_timeout_rate`` — per-*attempt* timeout probability; bounded
      retry with exponential backoff may still succeed.
    * ``peer_slow_rate`` / ``slow_factor`` — the attempt succeeds but
      the transfer is charged ``slow_factor ×`` the peer-link time.
    * ``outage_districts`` / ``flap_period`` / ``server_outage_rate`` —
      dark edge servers: pinned districts, a deterministic epoch flap,
      or a per-(district, epoch) rate.
    * ``center_down`` / ``center_outage_rate`` — the forwarded-path
      fallback is itself unreachable.
    * ``max_retries`` / ``backoff_ms`` / ``link_timeout_ms`` — the
      degradation knobs: attempts = ``max_retries + 1``, attempt k ≥ 1
      first waits ``backoff_ms · 2^(k-1)``, every failed attempt is
      charged ``link_timeout_ms`` of virtual time.
    """
    seed: int = 0
    peer_drop_rate: float = 0.0
    peer_timeout_rate: float = 0.0
    peer_slow_rate: float = 0.0
    slow_factor: float = 4.0
    server_outage_rate: float = 0.0
    outage_districts: tuple = ()
    flap_period: int = 0
    center_down: bool = False
    center_outage_rate: float = 0.0
    max_retries: int = 2
    backoff_ms: float = 1.0
    link_timeout_ms: float = 25.0

    def __post_init__(self):
        for name in _RATE_FIELDS:
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v!r}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.slow_factor < 1.0:
            raise ValueError("slow_factor must be >= 1")
        if self.flap_period < 0:
            raise ValueError("flap_period must be >= 0")
        if self.backoff_ms < 0.0 or self.link_timeout_ms < 0.0:
            raise ValueError("backoff_ms / link_timeout_ms must be >= 0")
        object.__setattr__(self, "outage_districts",
                           tuple(int(d) for d in self.outage_districts))

    @property
    def enabled(self) -> bool:
        """False ⇒ the plan injects nothing and every consumer must be
        bit-for-bit with the fault-free path (the parity acceptance
        gate; ``ServingPolicy`` normalizes a disabled plan to None)."""
        return bool(self.peer_drop_rate or self.peer_timeout_rate
                    or self.peer_slow_rate or self.server_outage_rate
                    or self.center_outage_rate or self.outage_districts
                    or self.flap_period or self.center_down)


#: the canonical disabled plan
NO_FAULTS = FaultPlan()


class ExchangeOutcome(NamedTuple):
    """One bounded-retry peer exchange under injection."""
    ok: bool
    fault: str | None        # "drop" | "timeout" when not ok
    charged_ms: float        # timeouts + backoff charged to the lane
    slow: bool               # succeeded over a degraded (slow) link
    moved: int               # border rows actually transferred


def _fresh_stats() -> dict:
    return {"link_attempts": 0, "drops": 0, "timeouts": 0, "slow": 0,
            "retries": 0, "backoff_ms": 0.0, "exchanges_ok": 0,
            "exchanges_failed": 0}


class FaultInjector:
    """Runtime for one ``FaultPlan``: stateless seeded draws + an event
    log.  The only mutable state is the epoch counter (advanced by
    ``tick`` once per consumer batch/event) and the bookkeeping
    (``stats`` / ``events``) — outcomes themselves are pure functions of
    ``(plan.seed, epoch, kind, key)``, so replay is independent of call
    interleaving and of everything outside the plan."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.epoch = 0
        self.stats = _fresh_stats()
        # (tag, epoch, src, dst, attempt, outcome) — byte-for-byte
        # reproducible given the same plan + workload (the replay pin)
        self.events: list[tuple] = []

    def _u(self, kind: int, *key: int) -> float:
        return float(np.random.default_rng(
            (int(self.plan.seed), int(self.epoch), int(kind))
            + tuple(int(k) for k in key)).random())

    def tick(self) -> int:
        """Advance the fault epoch (one per batch / simulator event):
        epoch-keyed draws — link drops, server outages — re-sample."""
        self.epoch += 1
        return self.epoch

    # -- availability draws --------------------------------------------------

    def server_down(self, district: int) -> bool:
        p = self.plan
        d = int(district)
        if d in p.outage_districts:
            return True
        if p.flap_period and ((self.epoch // p.flap_period) + d) % 2 == 1:
            return True
        return bool(p.server_outage_rate) and \
            self._u(KIND_SERVER, d) < p.server_outage_rate

    def center_down(self) -> bool:
        p = self.plan
        if p.center_down:
            return True
        return bool(p.center_outage_rate) and \
            self._u(KIND_CENTER) < p.center_outage_rate

    # -- peer links ----------------------------------------------------------

    def peer_attempt(self, src: int, dst: int, attempt: int) -> str:
        """One link attempt: ``"ok" | "drop" | "timeout" | "slow"``.
        Drops are keyed per (link, epoch) — permanent for the epoch, so
        retries stop immediately; timeouts and slow links are keyed per
        attempt, so bounded retry can ride one out."""
        p = self.plan
        out = "ok"
        if p.peer_drop_rate and \
                self._u(KIND_LINK_DROP, src, dst) < p.peer_drop_rate:
            out = "drop"
        elif p.peer_timeout_rate and \
                self._u(KIND_LINK_TIMEOUT, src, dst,
                        attempt) < p.peer_timeout_rate:
            out = "timeout"
        elif p.peer_slow_rate and \
                self._u(KIND_LINK_SLOW, src, dst,
                        attempt) < p.peer_slow_rate:
            out = "slow"
        self.stats["link_attempts"] += 1
        if out != "ok":
            self.stats[out + "s" if out != "slow" else "slow"] += 1
        self.events.append(("link", self.epoch, int(src), int(dst),
                            int(attempt), out))
        return out

    def link_trial(self, src: int, dst: int
                   ) -> tuple[bool, str | None, float, bool]:
        """The bounded-retry + exponential-backoff loop, draws only (no
        data movement — the simulator/loadgen view of ``exchange``).
        Returns ``(ok, fault, charged_ms, slow)``."""
        p = self.plan
        charged = 0.0
        for attempt in range(p.max_retries + 1):
            if attempt:
                back = p.backoff_ms * (2.0 ** (attempt - 1))
                charged += back
                self.stats["retries"] += 1
                self.stats["backoff_ms"] += back
            outcome = self.peer_attempt(src, dst, attempt)
            if outcome == "drop":       # permanent this epoch: stop early
                return False, "drop", charged + p.link_timeout_ms, False
            if outcome == "timeout":
                charged += p.link_timeout_ms
                continue
            return True, None, charged, outcome == "slow"
        return False, "timeout", charged, False

    def exchange(self, server, peer) -> ExchangeOutcome:
        """``EdgeServer.exchange_border_rows`` under injection: run the
        retry loop, move the rows only if a trial succeeds."""
        ok, fault, charged, slow = self.link_trial(server.district_id,
                                                   peer.district_id)
        moved = 0
        if ok:
            moved = server.exchange_border_rows(peer)
            self.stats["exchanges_ok"] += 1
        else:
            self.stats["exchanges_failed"] += 1
        return ExchangeOutcome(ok, fault, float(charged), slow, int(moved))


# -- availability scenarios ---------------------------------------------------

def link_loss_sweep(rates, seed: int = 0, **knobs) -> list[FaultPlan]:
    """One ``FaultPlan`` per peer-link loss rate (the availability sweep
    of the scatter benchmarks: p99 + goodput vs loss)."""
    return [FaultPlan(seed=seed, peer_drop_rate=float(r), **knobs)
            for r in rates]


def district_outage_storm(num_districts: int, dark_frac: float = 0.25,
                          seed: int = 0, **knobs) -> FaultPlan:
    """A plan with a deterministic set of dark districts (at least one
    district always survives, so the surviving-min reroute has a
    destination)."""
    if num_districts < 1:
        raise ValueError("num_districts must be >= 1")
    k = int(round(float(dark_frac) * num_districts))
    k = max(0, min(k, num_districts - 1))
    rng = np.random.default_rng((int(seed), KIND_STORM))
    dark = rng.choice(num_districts, size=k, replace=False) if k else []
    return FaultPlan(seed=seed,
                     outage_districts=tuple(sorted(int(d) for d in dark)),
                     **knobs)


def loadgen_network_model(plan: FaultPlan, topo, src_d: np.ndarray,
                          dst_d: np.ndarray, cross: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Vectorized per-request network view for the open-loop harness
    (millions of arrivals — one RNG stream seeded from the plan, not a
    per-request injector).  Returns ``(rtt_ms, degraded, info)``:

    * healthy cross lanes pay the peer RTT (slow links pay the
      ``slow_factor`` surcharge on the peer hop);
    * failed exchanges (drop, or every retry timing out) are charged
      the full retry/backoff budget, then forwarded through the center
      (still exact) — or, with the center dark too, answered locally
      from stale rows and flagged ``degraded``;
    * dark source districts reroute cross lanes to the target's server
      (surviving min, same peer RTT) and push same-district lanes to
      the center's certified upper bound (degraded).
    """
    src_d = np.asarray(src_d)
    dst_d = np.asarray(dst_d)
    cross = np.asarray(cross, dtype=bool)
    n = len(src_d)
    lm = topo.latency
    rng = np.random.default_rng((int(plan.seed), KIND_LOADGEN))
    edge, peer, fwd = (topo.edge_rtt_ms(), topo.peer_rtt_ms(),
                       topo.forward_rtt_ms())
    rtt = np.where(cross, peer, edge).astype(np.float64)
    degraded = np.zeros(n, dtype=bool)

    m = int(topo.num_districts)
    down = np.zeros(m, dtype=bool)
    for d in plan.outage_districts:
        if 0 <= d < m:
            down[d] = True
    if plan.server_outage_rate:
        down |= rng.random(m) < plan.server_outage_rate
    center_up = not plan.center_down
    if center_up and plan.center_outage_rate:
        center_up = not bool(rng.random() < plan.center_outage_rate)

    src_down = down[src_d]
    dst_down = down[dst_d]
    healthy_cross = cross & ~src_down & ~dst_down

    # peer-link failures on healthy cross lanes: drop is permanent, a
    # timeout must hit all max_retries+1 attempts to fail the exchange
    k = plan.max_retries + 1
    p_fail = plan.peer_drop_rate + \
        (1.0 - plan.peer_drop_rate) * plan.peer_timeout_rate ** k
    fail = np.zeros(n, dtype=bool)
    slow = np.zeros(n, dtype=bool)
    if p_fail:
        fail = healthy_cross & (rng.random(n) < p_fail)
    if plan.peer_slow_rate:
        slow = healthy_cross & ~fail & (rng.random(n) < plan.peer_slow_rate)
    # worst-case bounded charge: k timeouts + the full backoff ladder
    charge = k * plan.link_timeout_ms + \
        plan.backoff_ms * (2.0 ** (k - 1) - 1.0)
    if center_up:
        rtt[fail] = fwd + charge
    else:
        rtt[fail] = edge + charge
        degraded |= fail
    rtt[slow] += (plan.slow_factor - 1.0) * lm.peer_edge_ms

    # dark source district: cross lanes reroute to the survivor (same
    # peer RTT); both-dark and same-district lanes fall to the center
    both_dark = cross & src_down & dst_down
    same_dark = ~cross & src_down
    if center_up:
        rtt[both_dark] = fwd
        rtt[same_dark] = fwd
    else:
        rtt[both_dark] = edge
        rtt[same_dark] = edge
        degraded |= both_dark
    degraded |= same_dark               # upper bound: always flagged
    info = {"failed_links": int(fail.sum()), "slow_links": int(slow.sum()),
            "dark_districts": int(down.sum()), "center_up": center_up,
            "rerouted": int((cross & src_down & ~dst_down).sum())}
    return rtt, degraded, info
