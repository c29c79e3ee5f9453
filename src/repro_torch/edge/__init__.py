"""Edge-computing runtime of the port: center + edge servers (§4), the
replicated batched serving engine and the host table layout."""
from .center import ComputingCenter
from .server import EdgeServer
from .router import EdgeSystem
from .engine import BatchedQueryEngine
from .sharded_oracle import ShardedOracleData, pack_tables, prepare_queries

__all__ = [n for n in dir() if not n.startswith("_")]
