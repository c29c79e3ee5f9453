"""Ingest for the port: streaming CSR construction, the seeded
synthetic-continent generator and the seeded closure storm (copies of
``repro.ingest.csr`` and ``repro.ingest.synth``)."""
from .csr import CSRArrays, CSRBuilder
from .synth import closure_storm, synthetic_continent

__all__ = [n for n in dir() if not n.startswith("_")]
