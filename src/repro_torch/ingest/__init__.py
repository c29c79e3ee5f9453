"""Ingest for the port: streaming CSR construction, the chunked DIMACS
``.gr`` reader, the seeded synthetic-continent generator, the seeded
closure storm and the checksum-pinned dataset registry (copies of
``repro.ingest.csr``, ``dimacs``, ``synth`` and ``datasets``; ``fetch``
downloads only when called, and nothing in the repository calls it)."""
from .csr import CSRArrays, CSRBuilder
from .dimacs import DimacsFormatError, iter_gr, load_gr_csr, load_gr_graph
from .synth import closure_storm, synthetic_continent
from .datasets import DATASETS, DatasetSpec, dataset_path, fetch, sha256_of

__all__ = [n for n in dir() if not n.startswith("_")]
