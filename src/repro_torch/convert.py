"""Carry a built index, or a builder's state, across to the port,
without rebuilding it.

``index_to_numpy`` reads a deployed system — the port's own, or any
object with the same attributes, such as the JAX package's
``EdgeSystem`` (read by duck typing; nothing of it is imported) — into a
flat dict of numpy arrays. ``system_from_numpy`` builds the port's
``EdgeSystem`` from that dict on a torch device. Serving can then be
held against the reference on the reference's exact index, apart from
building.

``build_state_to_numpy`` / ``build_state_from_numpy`` do the same for
the staged builder's ``BuildState`` (the JAX package's or the port's):
the cache that delta-scoped repairs warm-start from.

``lm_params_from_numpy`` carries an LM's params across: the JAX
package's ``init_params`` tree as numpy arrays becomes the port's params
on a torch device, so both packages compute with the same weights;
``lm_params_to_numpy`` goes back. ``opt_state_from_numpy`` /
``opt_state_to_numpy`` do the same for the optimizer state (``m``,
``v``, ``step``), so training can continue in either package.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.graph import Graph
from .core.labels import BorderLabels, SparseLabels
from .core.local_index import LocalIndex
from .core.partition import Partition
from .core.torch_builder import BuildState, PackedDistricts
from .device import resolve_device
from .edge.center import ComputingCenter
from .edge.router import EdgeSystem
from .edge.server import EdgeServer


def index_to_numpy(system) -> dict[str, np.ndarray]:
    """The deployed index of ``system`` as named numpy arrays: the graph
    CSR, the partition, B, the center's version and, per district i,
    ``d{i}/vertices``, ``d{i}/border_locals``, ``d{i}/plain_hubs``,
    ``d{i}/plain_dists``, ``d{i}/aug_hubs``, ``d{i}/aug_dists`` (absent
    while the server has no L_i⁺) and ``d{i}/augmented_version``."""
    g, part, center = system.graph, system.partition, system.center
    bl = center.border_labels
    out = {"indptr": np.asarray(g.indptr),
           "indices": np.asarray(g.indices),
           "weights": np.asarray(g.weights),
           "assignment": np.asarray(part.assignment),
           "num_districts": np.int64(part.num_districts),
           "border_ids": np.asarray(bl.border_ids),
           "table": np.asarray(bl.table),
           "version": np.int64(center.version)}
    for i, srv in enumerate(system.servers):
        out[f"d{i}/vertices"] = np.asarray(srv.plain.vertices)
        out[f"d{i}/border_locals"] = np.asarray(srv.plain.border_locals)
        out[f"d{i}/plain_hubs"] = np.asarray(srv.plain.labels.hubs)
        out[f"d{i}/plain_dists"] = np.asarray(srv.plain.labels.dists)
        if srv.augmented is not None:
            out[f"d{i}/aug_hubs"] = np.asarray(srv.augmented.labels.hubs)
            out[f"d{i}/aug_dists"] = np.asarray(srv.augmented.labels.dists)
        out[f"d{i}/augmented_version"] = np.int64(srv.augmented_version)
    return out


def system_from_numpy(state: dict[str, np.ndarray],
                      device: torch.device | str | None = None
                      ) -> EdgeSystem:
    """The port's ``EdgeSystem`` serving exactly the index in ``state``
    (as written by ``index_to_numpy``), with its tables on ``device``."""
    device = resolve_device(device)
    g = Graph(np.asarray(state["indptr"]), np.asarray(state["indices"]),
              np.asarray(state["weights"], dtype=np.float32))
    part = Partition(np.asarray(state["assignment"], dtype=np.int32),
                     int(state["num_districts"]))
    center = ComputingCenter(
        g, part, BorderLabels(np.asarray(state["border_ids"]),
                              np.asarray(state["table"], dtype=np.float32)),
        version=int(state["version"]), device=device)
    servers = []
    for i in range(part.num_districts):
        vertices = np.asarray(state[f"d{i}/vertices"])
        border_locals = np.asarray(state[f"d{i}/border_locals"],
                                   dtype=np.int64)

        def index(kind: str, augmented: bool) -> LocalIndex:
            labels = SparseLabels(np.asarray(state[f"d{i}/{kind}_hubs"]),
                                  np.asarray(state[f"d{i}/{kind}_dists"]))
            return LocalIndex(i, vertices, border_locals, labels,
                              augmented=augmented, device=device)

        srv = EdgeServer(i, index("plain", False))
        if f"d{i}/aug_hubs" in state:
            srv.augmented = index("aug", True)
        srv.augmented_version = int(state[f"d{i}/augmented_version"])
        servers.append(srv)
    return EdgeSystem(g, part, center, servers)


_PACKED = ("adj", "vertex_ids", "border_pos", "border_ids", "border_slot")
_STAGES = ("intra", "overlay", "closure", "unpruned", "table")


def build_state_to_numpy(state) -> dict[str, np.ndarray]:
    """A builder's ``BuildState`` as named numpy arrays: ``packed/<field>``
    for the packed districts (``packed/kmax`` and ``packed/bmax`` as
    scalars), one array per stage output, the CSR ``weights``, and
    ``prune_order`` (absent when the table is unpruned)."""
    packed = state.packed
    out = {f"packed/{k}": np.asarray(getattr(packed, k)) for k in _PACKED}
    out["packed/kmax"] = np.int64(packed.kmax)
    out["packed/bmax"] = np.int64(packed.bmax)
    out.update({k: np.asarray(getattr(state, k)) for k in _STAGES})
    out["weights"] = np.asarray(state.weights)
    if state.prune_order is not None:
        out["prune_order"] = np.asarray(state.prune_order)
    return out


def build_state_from_numpy(d: dict[str, np.ndarray]) -> BuildState:
    """The port's ``BuildState`` holding exactly the arrays of ``d`` (as
    written by ``build_state_to_numpy``); host-side, with no device
    table."""
    packed = PackedDistricts(*(np.asarray(d[f"packed/{k}"])
                               for k in _PACKED),
                             kmax=int(d["packed/kmax"]),
                             bmax=int(d["packed/bmax"]))
    order = d.get("prune_order")
    return BuildState(packed, *(np.asarray(d[k]) for k in _STAGES),
                      prune_order=None if order is None
                      else np.asarray(order),
                      weights=np.asarray(d["weights"]))


def _tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                          # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16, from JAX
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(tree: dict, *,
                         device: torch.device | str | None = None) -> dict:
    """The port's LM params holding exactly the arrays of ``tree`` (the
    JAX package's ``init_params`` tree as numpy arrays: nested dicts,
    layer leaves stacked along a leading ``L`` axis), on ``device``.
    bfloat16 arrays are carried through their 16-bit patterns, so every
    value arrives unchanged."""
    device = resolve_device(device)
    return {k: lm_params_from_numpy(v, device=device)
            if isinstance(v, dict) else _tensor_from_numpy(v, device)
            for k, v in tree.items()}


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM params (or any nested dict of tensors) as numpy
    arrays on the host, keys and layout unchanged; bfloat16 tensors as
    ``ml_dtypes.bfloat16`` arrays (the dtype JAX takes), through their
    16-bit patterns."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes             # the JAX package's numpy bf16
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return {k: lm_params_to_numpy(v) if isinstance(v, dict) else host(v)
            for k, v in params.items()}


def opt_state_from_numpy(state: dict, *,
                         device: torch.device | str | None = None) -> dict:
    """The port's optimizer state holding exactly the arrays of
    ``state`` (the JAX package's ``init_opt_state`` / ``adamw_update``
    state as numpy arrays: ``m`` and ``v`` trees and the int32 ``step``)
    on ``device``."""
    return lm_params_from_numpy(state, device=device)


def opt_state_to_numpy(state: dict) -> dict:
    """The port's optimizer state as numpy arrays (``step`` a 0-dim
    int32 array), for the JAX package's ``adamw_update``."""
    return lm_params_to_numpy(state)
