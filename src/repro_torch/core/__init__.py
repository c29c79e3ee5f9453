"""Core library of the port: graph substrate, PLL, Border Labeling,
shortcuts, quantized storage, local indexes, the §4.2 routing rules and
the paper's ``DistanceOracle`` API.

Host NumPy copies of the matching ``repro.core`` modules (the port
imports nothing of the JAX package); ``local_index`` additionally keeps
its serving layouts on a torch device, and ``torch_builder`` (the
counterpart of ``repro.core.jax_builder``) builds B on a torch device
with the min-plus kernels."""
from .graph import (Graph, from_edges, grid_road_network,
                    random_geometric_network, load_dimacs_gr, dijkstra,
                    perturb_weights, bidirectional_dijkstra,
                    all_pairs_dijkstra, is_connected)
from .labels import SparseLabels, BorderLabels, pack_sparse
from .ordering import degree_order, rank_of
from .partition import Partition, bfs_grow_partition, grid_partition, \
    borders_of, border_mask
from .pll import pll, pll_subgraph
from .border_labeling import (build_border_labels_reference,
                              build_border_labels_hierarchical,
                              minplus, minplus_closure)
from .torch_builder import (BuildState, PackedDistricts,
                            build_border_labels_stages,
                            build_border_labels_torch, hub_prune_order,
                            pack_districts)
from .shortcuts import border_shortcut_matrix, shortcut_edges
from .local_index import LocalIndex, build_local_index, \
    build_all_local_indexes
from .query import (Rule, route, cross_district_query, same_district_query,
                    local_bound, certified_local_query, bucket_by_rule,
                    query_batch)
from .quantize import (LABEL_DTYPES, QuantSpec, dtype_name, fit_label_spec,
                       sentinel_of)
from .oracle import DistanceOracle, BuildStats

__all__ = [n for n in dir() if not n.startswith("_")]
