"""Request plane of the port: ``DistanceService`` + ``ServingPolicy`` +
the ``QueryPlane`` implementations; and batched LM decode scheduling
(``BatchedDecoder``, ``Request``; decode_step itself lives in
``models.lm``)."""
from .batcher import BatchedDecoder, Request
from .service import (CERTIFIED_STALE, CERTIFY_OR_WAIT, EXACT, INSTALL_NOW,
                      REBUILD_MODES, STALE, STALE_OK, BucketedPlane,
                      DistanceService, QueryPlan, QueryPlane, QueryRequest,
                      QueryResult, ResultBatch, ScalarLoopPlane,
                      ServingPolicy)

__all__ = [n for n in dir() if not n.startswith("_")]
