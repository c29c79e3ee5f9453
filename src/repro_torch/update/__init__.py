"""Dynamic traffic updates of the port: delta classification,
delta-scoped index repair on a torch device (bit for bit equal to a full
rebuild), and traffic-scenario generators. Structural deltas
(closures/openings) live in ``topo``; ``IncrementalBuilder`` repairs
both kinds."""
from .delta import WeightDelta, classify_delta, weights_from_arc_updates
from .incremental import IncrementalBuilder
from .scenarios import (SCENARIOS, incident, regional_slowdown,
                        rush_hour_corridor, scenario_weights,
                        uniform_jitter)

__all__ = [n for n in dir() if not n.startswith("_")]
