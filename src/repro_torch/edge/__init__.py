"""Edge-computing runtime of the port: center + edge servers (§4), the
replicated and district-sharded batched serving engines, and the
districts → logical shards layout over an ``EdgeMesh``."""
from .center import ComputingCenter
from .server import EdgeServer
from .router import EdgeSystem
from .engine import BatchedQueryEngine, ShardedBatchedEngine
from .sharded_oracle import (EdgeMesh, ShardedOracleData, default_edge_mesh,
                             pack_for_mesh, pack_tables, prepare_queries,
                             make_sharded_query_fn, sharded_query)

__all__ = [n for n in dir() if not n.startswith("_")]
