"""Query processing: routing rules (§4.2), λ joins, Local Bound (Thm 3).

Routing (seen from the edge server that receives the query):
  rule 1 — s and t in this server's district  → answer locally via L_i⁺;
  rule 2 — s and t both in some *other* district → forward via the center
           to that district's server (center acts as forwarding agent);
  rule 3 — s and t in different districts → the center answers via B.

``local_bound`` implements Definition 5 / Theorem 3: with only the plain
local index L_i, a local answer λ(s,t,L_i) is certified globally exact
whenever it does not exceed min_b λ(s,b,L_i) + min_b' λ(b',t,L_i) — any
path escaping the district pays at least that much before re-entering.

``query_batch`` answers a batch where the local indexes serve: rules 1/2
through each district's dense join on its device, rule 3 through the
same join over B on that device.
"""
from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from ..kernels.label_join import ops as lj
from .labels import BorderLabels
from .local_index import LocalIndex

INF = np.float32(np.inf)


class Rule(IntEnum):
    LOCAL = 1          # same district as the receiving server
    FORWARD_EDGE = 2   # same district, but another server's
    CROSS = 3          # different districts → computing center


def route(s_district: int, t_district: int, server_district: int) -> Rule:
    if s_district != t_district:
        return Rule.CROSS
    return Rule.LOCAL if s_district == server_district else Rule.FORWARD_EDGE


def cross_district_query(bl: BorderLabels, s: int, t: int) -> float:
    """Rule-3 answer at the computing center (Theorem 1)."""
    return bl.query(s, t)


def same_district_query(idx: LocalIndex, s: int, t: int) -> float:
    """Rule-1/2 answer at an edge server holding L_i⁺ (Theorem 2)."""
    sl, tl = int(idx.local_of(np.array([s]))[0]), \
        int(idx.local_of(np.array([t]))[0])
    return idx.query_local(sl, tl)


def local_bound(idx: LocalIndex, s_local: int, t_local: int) -> float:
    """LB(s,t,L_i,B_i) = min_b λ(s,b,L_i) + min_b' λ(b',t,L_i)."""
    if len(idx.border_locals) == 0:
        return float(INF)
    return float(idx.border_dist[s_local].min()
                 + idx.border_dist[t_local].min())


def certified_local_query(idx: LocalIndex, s: int, t: int
                          ) -> tuple[float, bool]:
    """Answer with the *plain* local index if Theorem 3 certifies it.

    Returns (distance, certified). When not certified the local estimate is
    still an upper bound, but the caller must defer to the center's B.
    """
    sl = int(idx.local_of(np.array([s]))[0])
    tl = int(idx.local_of(np.array([t]))[0])
    lam = idx.query_local(sl, tl)
    lb = local_bound(idx, sl, tl)
    return float(lam), bool(lam <= lb)


def bucket_by_rule(assignment: np.ndarray, ss: np.ndarray, ts: np.ndarray,
                   client_districts: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized §4.2 routing for a whole batch in one NumPy pass.

    Returns (ds, dt, rules): per-query source/target districts plus the
    Rule value each query falls under (rule 2 only differs from rule 1
    when the client submitted from a district other than s's)."""
    ds = assignment[ss].astype(np.int32)
    dt = assignment[ts].astype(np.int32)
    if client_districts is None:        # client == ds: rule 2 can't fire
        rules = np.where(ds != dt, np.int32(Rule.CROSS),
                         np.int32(Rule.LOCAL))
        return ds, dt, rules
    client = np.asarray(client_districts, dtype=np.int32)
    rules = np.where(ds != dt, np.int32(Rule.CROSS),
                     np.where(ds == client, np.int32(Rule.LOCAL),
                              np.int32(Rule.FORWARD_EDGE)))
    return ds, dt, rules


def query_batch(bl: BorderLabels, locals_: list[LocalIndex],
                assignment: np.ndarray, ss: np.ndarray, ts: np.ndarray,
                btable: torch.Tensor | None = None) -> np.ndarray:
    """Batched routing + answering: bucket by rule in one pass, answer
    rule-1/2 per district through ``LocalIndex.query_local_many`` (the
    dense join on the index's device), rule-3 through the same join
    over B on that device, and consolidate with a single scatter per
    bucket. ``btable`` is B already resident there; None uploads it for
    this call."""
    ss = np.asarray(ss, dtype=np.int64)
    ts = np.asarray(ts, dtype=np.int64)
    out = np.full(len(ss), INF, dtype=np.float32)
    ds, _, rules = bucket_by_rule(assignment, ss, ts)
    cross_idx = np.nonzero(rules == np.int32(Rule.CROSS))[0]
    if len(cross_idx):
        if btable is None:
            btable = lj.upload(bl.table.astype(np.float32, copy=False),
                               locals_[0].device)
        out[cross_idx] = lj.join_gathered(btable, ss[cross_idx],
                                          ts[cross_idx])
    same = rules != np.int32(Rule.CROSS)
    for i, idx in enumerate(locals_):
        sel = np.nonzero(same & (ds == np.int32(i)))[0]
        if not len(sel):
            continue
        out[sel] = idx.query_local_many(idx.local_of(ss[sel]),
                                        idx.local_of(ts[sel]))
    return out
