"""Request plane of the port: ``DistanceService`` + ``ServingPolicy`` +
the ``QueryPlane`` implementations, the distance-query micro-batcher,
the open-loop load harness; and batched LM decode scheduling
(``BatchedDecoder``, ``Request``; decode_step itself lives in
``models.lm``)."""
from .batcher import BatchedDecoder, Request
from .distance_batcher import DistanceBatcher, DistanceRequest
from .loadgen import (LoadReport, OpenLoopLoadGen, close_rebuild_window,
                      open_rebuild_window, request_rtt_ms)
from .service import (CERTIFIED_STALE, CERTIFY_OR_WAIT, EXACT, INSTALL_NOW,
                      MIGRATION_DUAL, MIGRATION_HANDOFF, MIGRATION_MODES,
                      REBUILD_MODES, STALE, STALE_OK, BucketedPlane,
                      DistanceService, QueryPlan, QueryPlane, QueryRequest,
                      QueryResult, ResultBatch, ScalarLoopPlane,
                      ServingPolicy)

__all__ = [n for n in dir() if not n.startswith("_")]
