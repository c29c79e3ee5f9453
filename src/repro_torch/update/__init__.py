"""Traffic updates of the port: the stateful builder the computing
center rebuilds B through. Only the full pipeline run is ported; the
delta-scoped repairs come with ROADMAP Queue 1 item 6."""
from .incremental import IncrementalBuilder

__all__ = [n for n in dir() if not n.startswith("_")]
