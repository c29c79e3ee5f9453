"""Dynamic topology of the port: structural deltas (road closures and
openings as genuine CSR changes), classified for the scoped structural
repair of ``update.IncrementalBuilder.apply_structural``.

Online repartitioning (``rebalance``) comes with the sharded layouts
(ROADMAP Queue 1 item 7): its placement feeds only the sharded engine
and the scatter-gather plane."""
from .structural import (StructuralDelta, classify_structural,
                         close_edges, open_edges)

__all__ = [n for n in dir() if not n.startswith("_")]
