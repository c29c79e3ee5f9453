"""Ingest for the port: streaming CSR construction and the seeded
synthetic-continent generator (copies of ``repro.ingest.csr`` and
``repro.ingest.synth``)."""
from .csr import CSRArrays, CSRBuilder
from .synth import synthetic_continent

__all__ = [n for n in dir() if not n.startswith("_")]
