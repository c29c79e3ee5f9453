"""Edge-computing runtime of the port: center + edge servers (§4), the
replicated and district-sharded batched serving engines, the
scatter-gather plane and its fault injection, the discrete-event
latency simulator (§5 dynamic scenario), and the districts → logical
shards layout over an ``EdgeMesh``."""
from .topology import LatencyModel, Topology
from .center import ComputingCenter
from .server import EdgeServer
from .router import EdgeSystem
from .engine import BatchedQueryEngine, ShardedBatchedEngine
from .scatter_gather import ScatterGatherPlane
from .faults import (NO_FAULTS, FaultInjector, FaultPlan,
                     district_outage_storm, link_loss_sweep)
from .simulator import (BatchPolicy, MigrationEvent, QueryEvent, SimResult,
                        UpdateSchedule, VariableUpdateSchedule, make_trace,
                        migrations_from_plan, run_update_epochs,
                        simulate_centralized, simulate_edge)
from .traffic import (TRAFFIC_SHAPES, arrival_times, poisson_count,
                      rate_profile)
from .sharded_oracle import (EdgeMesh, ShardedOracleData, default_edge_mesh,
                             pack_for_mesh, pack_tables, prepare_queries,
                             make_sharded_query_fn, sharded_query)

__all__ = [n for n in dir() if not n.startswith("_")]
