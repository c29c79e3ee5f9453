"""Edge-computing topology (§4.1): computing center + edge servers + clients.

Latency constants model the three-layer architecture: clients reach their
district's edge server over 5G; edge servers reach the cloud computing
center over the WAN, and neighboring edge servers reach each other over a
metro peer link (the scatter-gather read path — cross-district queries
answered edge-side never touch the WAN). The centralized baseline routes
every query from the client straight to the cloud.

A copy of the JAX package's ``repro.edge.topology`` (no JAX inside).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LatencyModel:
    """One-way network latencies in milliseconds."""
    client_edge_ms: float = 5.0       # 5G hop (§4.1)
    edge_center_ms: float = 30.0      # WAN hop
    client_center_ms: float = 35.0    # centralized baseline path
    peer_edge_ms: float = 8.0         # edge ↔ edge metro peer link

    # service times (per query, ms) — calibrated from the measured label
    # join costs; HL-based queries are microsecond-level (§5.1), so the
    # defaults keep them well below network latency.
    edge_service_ms: float = 0.02
    center_service_ms: float = 0.02
    centralized_service_ms: float = 0.02


@dataclass(frozen=True)
class Topology:
    num_districts: int
    latency: LatencyModel = LatencyModel()

    def edge_rtt_ms(self) -> float:
        return 2 * self.latency.client_edge_ms

    def forward_rtt_ms(self) -> float:
        # client → own edge → center (forwarding agent) → other edge → back
        return 2 * (self.latency.client_edge_ms
                    + 2 * self.latency.edge_center_ms)

    def center_rtt_ms(self) -> float:
        return 2 * (self.latency.client_edge_ms
                    + self.latency.edge_center_ms)

    def peer_rtt_ms(self) -> float:
        # client → own edge → peer edge hop amortized into the exchange;
        # the answer is consolidated at the client's own edge server, so
        # the round trip pays one peer hop each way instead of two WAN hops
        return 2 * (self.latency.client_edge_ms
                    + self.latency.peer_edge_ms)

    def centralized_rtt_ms(self) -> float:
        return 2 * self.latency.client_center_ms
