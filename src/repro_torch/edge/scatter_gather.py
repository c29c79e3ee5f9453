"""Scatter-gather read path: cross-edge serving with the center retired.

The port of ``repro.edge.scatter_gather``. The engines in
``edge/engine.py`` model the deployment as one table layout; this
module models it as the paper's §4 *network* — m autonomous edge
servers and a coordinator — while answering bit for bit the same
distances. A mixed-rule batch is split by the coordinator into one
partial query per district (the EdgeLake remote/local query rewriting,
SNIPPETS.md #1):

* rule 1/2 lanes go to the district's own server, which joins over its
  hub-aligned L_i⁺ block;
* rule 3 lanes go to the *source* district's server, which joins the
  source vertex's own B row against the target vertex's B row — a row it
  obtained from the target district's server through the peer-to-peer
  border-row exchange (``EdgeServer.exchange_border_rows``), never from
  the center. The §4.2 rule-3 identity ``d(s,t) = min_b B[s,b] +
  B[t,b]`` needs nothing else, so the computing center leaves the read
  path entirely: it builds B and pushes each district its slice
  (``ComputingCenter.border_rows_for``), then every query is answered
  edge-side over ``peer_edge_ms`` links instead of two WAN hops.

On one card each server is a logical shard, as in ``edge.sharded_oracle``:
server d's district block (``kmax`` rows of the packed layout) and the
border rows it holds are device tensors of its own. The rows it holds
live in its *view*, an (n, q) tensor in the storage dtype, allocated the
first time the server needs a border row; an exchange copies the newly
held rows into it once, and they persist. A batch uploads only its row
ids (once, grouped by owning server). Server d's partial is one launch:

* float32 storage — the sharded join kernel over [block; view]
  (``kernel.sharded_gather_join``): a row id below kmax reads the
  block, any other row r reads row r − kmax of the view, and a border
  row's lanes past q are the reference's +inf padding (never the min);
* quantized storage — the rows are gathered and dequantized on the card
  with ``QuantSpec.dequantize``'s arithmetic (one float32 multiply,
  sentinel → +inf), then joined in float32 by the dense join
  (``ops.join_partial_gathered``), as the reference dequantizes before
  its join: bit for bit with it under a lossy spec too.

Each lane is owned by exactly one server, so the coordinator's
consolidation is the partials concatenated on the card and put back in
lane order: the same bits as the reference's MIN over m full-batch
partials. The plane implements the ``QueryPlane`` protocol; select it
with ``ServingPolicy(engine="scatter_gather")``. Latency consequences
are modeled in ``edge/simulator.py`` and ``serve/loadgen.py``
(cross-district requests pay ``Topology.peer_rtt_ms()`` instead of
``forward_rtt_ms()``).

**Faults** (``edge/faults.py``): with ``ServingPolicy(faults=...)`` the
plane runs every peer exchange through a deterministic ``FaultInjector``
and degrades instead of erroring — bounded retry + backoff on the link,
(s, t)-swap reroute to the surviving district's server when the owner is
dark (bit-identical by min symmetry), forwarded-path fallback through
the center (exact for rule-3 lanes; one ``answer_cross_many`` call a
failing lane, as in the reference), previous-generation border rows
(flagged ``stale``), and finally a flagged +inf. After a faulted batch
the plane's ``exactness_codes`` / ``degraded`` arrays carry the
per-lane verdict into ``ResultBatch`` — no silent wrong answers. With
the plan disabled the fault path is never entered and the plane stays
bit for bit with the engines.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..core.local_index import LocalIndex
from ..core.quantize import QuantSpec
from ..device import resolve_device
from ..kernels.label_join import kernel as lj_kernel
from ..kernels.label_join import ops as lj
from ..kernels.label_join.ref import sharded_gather_rows, storage16
from .server import EdgeServer
from .sharded_oracle import pack_tables, prepare_queries

if TYPE_CHECKING:                                   # pragma: no cover
    from .router import EdgeSystem

INF = np.float32(np.inf)


def dequantize(codes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """``QuantSpec.dequantize`` on a device: 16-bit codes (uint16 stored
    as int16 bits) → float32 ``code · scale`` (one float32 multiply),
    the sentinel → +inf."""
    c = storage16(codes).to(torch.int32)
    if spec.sentinel == 0xFFFF:
        c = c & 0xFFFF
    # a float32 tensor times a Python float multiplies in float32 with
    # the scalar rounded to float32 first, as ``np.float32(scale)``
    out = c.to(torch.float32) * float(np.float32(spec.scale))
    return torch.where(c == spec.sentinel, float("inf"), out)


@dataclass
class ScatterGatherPlane:
    """Coordinator + per-district partial execution over the servers'
    own label stores. A snapshot of one index version, like the
    engines; the router rebuilds it when the center's version moves."""
    servers: list[EdgeServer]
    version: int
    device: torch.device
    data: object                        # ShardedOracleData, num_devices=m
    border_width: int
    # server d's district block (kmax, W) on ``device``
    _blocks: list[torch.Tensor] = field(repr=False)
    # per-server (n, q) view of the border rows it holds, scattered in
    # as slices arrive (own push + peer exchanges); lazily allocated so
    # servers that never see a cross lane hold no B bytes at all
    _bviews: list[torch.Tensor | None] = field(repr=False)
    _held: list[set] = field(repr=False)
    exchange_stats: dict = field(default_factory=lambda: {
        "exchanges": 0, "rows_exchanged": 0, "retries": 0,
        "failed_exchanges": 0, "charged_ms": 0.0, "co_hosted_rows": 0})
    # district → edge-host routing table (topo.EdgePlacement, set by the
    # router from EdgeSystem.placement).  Districts sharing a host
    # exchange border rows over loopback: the copy still happens, but it
    # is counted as co_hosted_rows instead of a peer-link exchange and
    # (in the faulted path) no link fault can apply.
    placement: object | None = field(default=None, repr=False)
    # fault-injection runtime (edge/faults.FaultInjector) — None on the
    # clean fast path, which then stays bit-for-bit with the engines
    faults: object | None = field(default=None, repr=False)
    # forwarded-path fallback target (ComputingCenter); only read when
    # degrading — the clean read path never touches it
    center: object | None = field(default=None, repr=False)
    # districts whose rows in a server's view are previous-generation
    _stale_held: list[set] = field(default_factory=list, repr=False)
    # per-batch degradation metadata (None after a clean batch); the
    # request plane lifts these into ResultBatch via getattr
    exactness_codes: np.ndarray | None = field(default=None, repr=False)
    degraded: np.ndarray | None = field(default=None, repr=False)
    # set ⇒ the district blocks and the per-server views hold
    # core.quantize codes (2 bytes/entry on every server); rows are
    # dequantized per batch before the join, so a lossless spec keeps
    # the plane bit-for-bit with the engines
    quant: QuantSpec | None = field(default=None, repr=False)

    def __post_init__(self):
        if not self._stale_held:
            self._stale_held = [set() for _ in self.servers]
        # what a server with no view joins against: one row of the min
        # identity (its lanes read no border row)
        fill = float("inf") if self.quant is None \
            else int(np.array(self.quant.sentinel, self.quant.dtype)
                     .view(np.int16))
        self._no_rows = torch.full(
            (1, self.border_width), fill, device=self.device,
            dtype=torch.float32 if self.quant is None else torch.int16)

    @classmethod
    def from_system(cls, system: "EdgeSystem", faults=None,
                    quant: QuantSpec | None = None
                    ) -> "ScatterGatherPlane":
        """Build from a deployed system, on its device: the center
        pushes each server its own district's B rows (the build-path
        role it keeps), then the coordinator packs the same blocked
        layout the sharded engine uses — one shard per district, so the
        routing pass emits per-district row coordinates directly."""
        center = system.center
        version = center.version
        for srv in system.servers:
            if not srv.has_border_rows(srv.district_id, version):
                verts, rows = center.border_rows_for(srv.district_id)
                srv.install_border_rows(verts, rows, version)
        plane = cls.build(center.border_labels.table,
                          [srv.augmented for srv in system.servers],
                          system.partition.assignment, system.servers,
                          version, quant=quant, device=system.device)
        plane.center = center
        plane.placement = system.placement
        if faults is not None and getattr(faults, "enabled", False):
            from .faults import FaultInjector
            plane.faults = FaultInjector(faults)
        return plane

    @classmethod
    def build(cls, btable: np.ndarray, locals_: list[LocalIndex],
              assignment: np.ndarray, servers: list[EdgeServer],
              version: int, quant: QuantSpec | None = None,
              device: torch.device | str | None = None
              ) -> "ScatterGatherPlane":
        device = resolve_device(device)
        m = len(locals_)
        data = pack_tables(btable, locals_, assignment, num_devices=m,
                           quant=quant)
        kmax = data.kmax
        blocks = [lj.upload(data.district_table[d * kmax:(d + 1) * kmax],
                            device) for d in range(m)]
        # the coordinator holds NO border rows — rule-3 gathers read the
        # servers' exchanged stores — and the blocks live on the device
        data.release_host_tables()
        return cls(servers, version, device, data, data.border_width,
                   blocks, [None] * m, [set() for _ in range(m)],
                   quant=quant)

    # -- border-row assembly -------------------------------------------------

    def _bview(self, d: int) -> torch.Tensor:
        if self._bviews[d] is None:
            self._bviews[d] = self._no_rows.expand(
                self.data.num_vertices, self.border_width).contiguous()
        return self._bviews[d]

    def _install_rows(self, d: int, verts: np.ndarray,
                      rows: np.ndarray) -> None:
        """Copy exchanged float32 B rows into server ``d``'s view, once
        (quantizing on arrival when the plane stores codes)."""
        if self.quant is not None:
            rows = self.quant.quantize(rows)
        idx = torch.from_numpy(np.asarray(verts, dtype=np.int64)).to(
            self.device)
        self._bview(d)[idx] = lj.upload(rows, self.device)

    def _co_hosted(self, d: int, j: int) -> bool:
        p = self.placement
        return p is not None and bool(p.host_of[d] == p.host_of[j])

    def _ensure_rows(self, d: int, districts: np.ndarray) -> None:
        """Make sure server ``d`` holds the B rows of every district in
        ``districts``, running peer exchanges for the ones it lacks.
        Co-hosted peers (same edge host under the current placement)
        copy over loopback — counted, but not as a peer-link exchange."""
        srv = self.servers[d]
        held = self._held[d]
        for j in np.unique(districts):
            j = int(j)
            if j in held:
                continue
            if j != d:
                moved = srv.exchange_border_rows(self.servers[j])
                if moved:
                    if self._co_hosted(d, j):
                        self.exchange_stats["co_hosted_rows"] += moved
                    else:
                        self.exchange_stats["exchanges"] += 1
                        self.exchange_stats["rows_exchanged"] += moved
            verts, rows = srv.border_rows_of(j)
            self._install_rows(d, verts, rows)
            held.add(j)

    def _partial(self, d: int, owner: torch.Tensor, rs: torch.Tensor,
                 rt: torch.Tensor) -> torch.Tensor:
        """Server ``d``'s answers on the lanes it owns (row ids of the
        block, or kmax + vertex for a held border row): one launch."""
        block = self._blocks[d]
        view = self._bviews[d] if self._bviews[d] is not None \
            else self._no_rows
        if self.quant is None:
            return lj_kernel.sharded_gather_join(block, view, owner, d, rs,
                                                 rt)
        s_rows, t_rows = sharded_gather_rows(block, view, rs, rt,
                                             quant=self.quant.key())
        return lj.join_partial_gathered(dequantize(s_rows, self.quant),
                                        dequantize(t_rows, self.quant))

    def _route(self, ss: np.ndarray, ts: np.ndarray
               ) -> tuple[list, np.ndarray, np.ndarray]:
        """The clean path's coordinator pass: each lane's owner and row
        ids, the lanes grouped by owner, and the peer exchanges their
        cross lanes need. Returns (groups, rs, rt)."""
        coords = prepare_queries(self.data, ss, ts)
        owner, rs, rt = coords["owner"], coords["rs"], coords["rt"]
        kmax = self.data.kmax
        groups = []
        for d in np.unique(owner):
            d = int(d)
            sel = np.nonzero(owner == d)[0]
            rt_d = rt[sel]
            cross_t = rt_d >= kmax
            if cross_t.any():
                # a cross lane reads the server's OWN B row on the
                # s-side and the peer district's on the t-side
                self._ensure_rows(d, np.append(
                    self.data.assignment[rt_d[cross_t] - kmax], d))
            groups.append((d, sel))
        return groups, rs, rt

    def _launch(self, groups: list[tuple[int, np.ndarray]],
                rs: np.ndarray, rt: np.ndarray
                ) -> tuple[np.ndarray, list[torch.Tensor]]:
        """Every server's partial over its lanes: ``groups`` lists
        (server, lane indices). The row ids go up once, grouped by
        server, and one launch a server joins its group. Returns the
        lanes in group order and the partials, still on the device."""
        lanes = np.concatenate([sel for _, sel in groups])
        owner = np.repeat([d for d, _ in groups],
                          [len(sel) for _, sel in groups])
        ids = torch.from_numpy(np.stack(
            [owner, rs[lanes], rt[lanes]]).astype(np.int64)).to(self.device)
        parts, a = [], 0
        for d, sel in groups:
            b = a + len(sel)
            parts.append(self._partial(d, ids[0, a:b], ids[1, a:b],
                                       ids[2, a:b]))
            a = b
        return lanes, parts

    @staticmethod
    def _consolidate(out: np.ndarray, lanes: np.ndarray,
                     parts: list[torch.Tensor]) -> np.ndarray:
        """The coordinator's gather: one server owns each lane, so the
        partials, concatenated on the device and copied back once, are
        the answers of ``lanes``."""
        out[lanes] = torch.cat(parts).cpu().numpy()
        return out

    # -- QueryPlane ----------------------------------------------------------

    def execute(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Scatter the batch into per-district partials and consolidate
        them (one server owns each lane). With a fault injector attached
        the batch runs through the degradation ladder instead
        (``_execute_faulted`` — same answers wherever nothing actually
        fails)."""
        ss = np.asarray(ss, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        self.exactness_codes = None     # per-batch metadata: reset so a
        self.degraded = None            # clean batch never leaks flags
        qn = len(ss)
        if qn == 0:
            return np.zeros(0, dtype=np.float32)
        if self.faults is not None:
            return self._execute_faulted(ss, ts)
        groups, rs, rt = self._route(ss, ts)
        return self._consolidate(np.empty(qn, dtype=np.float32),
                                 *self._launch(groups, rs, rt))

    query = execute
    __call__ = execute

    # -- graceful degradation under injected faults --------------------------

    def _ensure_rows_faulted(self, d: int, j: int) -> str:
        """Fault-aware counterpart of ``_ensure_rows`` for ONE peer
        district: make server ``d``'s view hold district ``j``'s B rows
        if any rung of the ladder can supply them.  Returns ``"ok"``
        (current rows present), ``"stale"`` (previous generation
        installed), or the blocking fault (``"drop" | "timeout" |
        "outage"``)."""
        srv = self.servers[d]
        held = self._held[d]
        stale_held = self._stale_held[d]
        if j in held and j not in stale_held:
            return "ok"
        if j == d or srv.has_border_rows(j, srv.border_rows_version):
            # own slice, or already cached server-side: no network hop,
            # so no fault can apply (also how a stale view heals)
            verts, rows = srv.border_rows_of(j)
            self._install_rows(d, verts, rows)
            held.add(j)
            stale_held.discard(j)
            return "ok"
        inj = self.faults
        if self._co_hosted(d, j) and not inj.server_down(j):
            # same edge host: the copy is loopback, no peer link to fault
            moved = srv.exchange_border_rows(self.servers[j])
            if moved:
                self.exchange_stats["co_hosted_rows"] += moved
            verts, rows = srv.border_rows_of(j)
            self._install_rows(d, verts, rows)
            held.add(j)
            stale_held.discard(j)
            return "ok"
        if inj.server_down(j):
            fault = "outage"
        else:
            outc = inj.exchange(srv, self.servers[j])
            st = self.exchange_stats
            st["charged_ms"] += outc.charged_ms
            if outc.ok:
                if outc.moved:
                    st["exchanges"] += 1
                    st["rows_exchanged"] += outc.moved
                verts, rows = srv.border_rows_of(j)
                self._install_rows(d, verts, rows)
                held.add(j)
                stale_held.discard(j)
                return "ok"
            st["failed_exchanges"] += 1
            st["retries"] = inj.stats["retries"]
            fault = outc.fault
        if j not in held:
            stale = srv.stale_border_rows_of(j)
            if stale is not None and \
                    stale[1].shape[1] == self.border_width:
                verts, rows = stale
                self._install_rows(d, verts, rows)
                held.add(j)
                stale_held.add(j)
        return "stale" if j in held else fault

    def _execute_faulted(self, ss: np.ndarray, ts: np.ndarray
                         ) -> np.ndarray:
        """The degradation ladder (module docstring of ``edge.faults``):
        reroute dark owners to the surviving min, retry peer links with
        backoff, forward failures through the center, serve stale rows,
        and flag whatever is left — every non-exact answer carries
        ``exactness_codes == 2`` and a ``degraded`` reason string. The
        surviving servers' partials are launched together after the
        ladder has run: a server's view is final once its own step
        has, and no later step touches it."""
        inj = self.faults
        inj.tick()
        qn = len(ss)
        kmax = self.data.kmax
        assignment = self.data.assignment
        out = np.full(qn, INF, dtype=np.float32)
        codes = np.zeros(qn, dtype=np.uint8)
        reasons = np.full(qn, None, dtype=object)
        live = np.ones(qn, dtype=bool)
        coords = prepare_queries(self.data, ss, ts)
        owner = coords["owner"].copy()
        rs, rt = coords["rs"].copy(), coords["rt"].copy()
        center_up = self.center is not None and not inj.center_down()

        def via_center(idx: np.ndarray, fault: str) -> None:
            # forwarded-path fallback: the center's B join is the §4.2
            # rule-3 identity, so cross lanes stay EXACT (the reason
            # records the reroute; exactness does not change)
            out[idx] = np.asarray(
                self.center.answer_cross_many(ss[idx], ts[idx]),
                dtype=np.float32)
            reasons[idx] = f"{fault}:forwarded_via_center"
            live[idx] = False

        def via_bound(idx: np.ndarray, fault: str) -> None:
            # same-district lanes on a dark server: min_b B[s,b]+B[t,b]
            # is a certified UPPER bound (triangle inequality over real
            # border paths) — served, but flagged stale
            out[idx] = np.asarray(
                self.center.answer_cross_many(ss[idx], ts[idx]),
                dtype=np.float32)
            codes[idx] = np.uint8(2)
            reasons[idx] = f"{fault}:border_upper_bound"
            live[idx] = False

        def unavailable(idx: np.ndarray, fault: str) -> None:
            codes[idx] = np.uint8(2)            # +inf, flagged — never
            reasons[idx] = f"{fault}:unavailable"   # a silent answer
            live[idx] = False

        # 1. dark owners: reroute cross lanes to the surviving min ----------
        orig_owner = coords["owner"]
        for d in np.unique(orig_owner):
            d = int(d)
            if not inj.server_down(d):
                continue
            idx = np.nonzero(orig_owner == d)[0]
            cross_l = rt[idx] >= kmax
            same_idx = idx[~cross_l]
            if len(same_idx):
                (via_bound if center_up else unavailable)(
                    same_idx, "server_outage")
            cidx = idx[cross_l]
            if len(cidx):
                # rule 3 from the surviving min: swap (s, t) so the
                # TARGET district's server owns the lane — identical
                # answer by symmetry of min_b B[s,b] + B[t,b]
                sw = prepare_queries(self.data, ts[cidx], ss[cidx])
                surv_dark = np.fromiter(
                    (inj.server_down(int(j)) for j in sw["owner"]),
                    dtype=bool, count=len(cidx))
                ok = cidx[~surv_dark]
                if len(ok):
                    owner[ok] = sw["owner"][~surv_dark]
                    rs[ok] = sw["rs"][~surv_dark]
                    rt[ok] = sw["rt"][~surv_dark]
                    reasons[ok] = "server_outage:rerouted_to_survivor"
                bad = cidx[surv_dark]
                if len(bad):
                    (via_center if center_up else unavailable)(
                        bad, "server_outage")

        # 2. surviving districts join their partials ------------------------
        groups = []
        for d in np.unique(owner[live]):
            d = int(d)
            sel = np.nonzero(live & (owner == d))[0]
            rs_d, rt_d = rs[sel], rt[sel]
            fault_of: dict[int, str] = {}
            stale_of: set[int] = set()
            if (rt_d >= kmax).any() or (rs_d >= kmax).any():
                # districts whose B rows this partial reads (a rerouted
                # lane's rs-side is the ORIGINAL source's district)
                need = np.concatenate([rs_d[rs_d >= kmax],
                                       rt_d[rt_d >= kmax]]) - kmax
                for j in np.unique(np.append(assignment[need], d)):
                    status = self._ensure_rows_faulted(d, int(j))
                    if status == "stale":
                        stale_of.add(int(j))
                    elif status != "ok":
                        fault_of[int(j)] = status
            # per-lane districts (d itself for local row ids)
            src_dist = np.where(
                rs_d >= kmax, assignment[np.maximum(rs_d - kmax, 0)], d)
            tgt_dist = np.where(
                rt_d >= kmax, assignment[np.maximum(rt_d - kmax, 0)], d)
            if fault_of:
                failing = np.array(sorted(fault_of), dtype=np.int64)
                bad = np.isin(src_dist, failing) | np.isin(tgt_dist,
                                                           failing)
                for lane, sd_, td_ in zip(sel[bad], src_dist[bad],
                                          tgt_dist[bad]):
                    f = fault_of.get(int(td_), fault_of.get(int(sd_)))
                    (via_center if center_up else unavailable)(
                        np.array([lane]), f"peer_{f}")
                keep = ~bad
                sel = sel[keep]
                src_dist, tgt_dist = src_dist[keep], tgt_dist[keep]
            if stale_of:
                staling = np.array(sorted(stale_of), dtype=np.int64)
                st = np.isin(src_dist, staling) | np.isin(tgt_dist,
                                                          staling)
                codes[sel[st]] = np.uint8(2)
                reasons[sel[st]] = "peer_link_down:stale_border_rows"
            if len(sel):
                groups.append((d, sel))
                live[sel] = False
        if groups:
            self._consolidate(out, *self._launch(groups, rs, rt))
        self.exactness_codes = codes
        self.degraded = reasons
        return out

    # -- accounting ----------------------------------------------------------

    def server_bytes(self) -> list[int]:
        """Device-resident bytes of each server: its district block plus
        its border-row view once allocated (both in the storage dtype —
        2 bytes/entry quantized)."""
        return [sum(x.numel() * x.element_size()
                    for x in (block, view) if x is not None)
                for block, view in zip(self._blocks, self._bviews)]

    def size_bytes(self) -> int:
        """Resident bytes across the servers (the coordinator holds
        none): the blocked district tables plus every allocated
        border-row view."""
        return sum(self.server_bytes())
