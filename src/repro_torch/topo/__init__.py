"""Dynamic topology of the port: structural deltas (road closures and
openings as genuine CSR changes), classified for the scoped structural
repair of ``update.IncrementalBuilder.apply_structural``, and online
district repartitioning between edge servers.

``rebalance`` watches per-district query load and resident bytes and
plans district migrations that ``EdgeSystem.migrate`` installs; the
placement becomes the sharded engine's device layout."""
from .rebalance import (EdgePlacement, MigrationMove, MigrationPlan,
                        RebalancePlanner, district_bytes_of)
from .structural import (StructuralDelta, classify_structural,
                         close_edges, open_edges)

__all__ = [n for n in dir() if not n.startswith("_")]
