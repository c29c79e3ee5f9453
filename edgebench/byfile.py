"""Parts of the harness found by name, one file a part.

A deployment kind (``deployments/<kind>.py``), a driver
(``drivers/<driver>.py``) and a judge (``judges/<pairs>.py``) are each a
module of their own that the manifest's files name, as a metric's reader
is (``metrics/<metric>.py``). So a later kind, driver or judge is a new
file and edits none that is there.
"""
from __future__ import annotations

import importlib
from pathlib import Path


class ByFile(dict):
    """``{name: attr of <package>.<name>}`` for every ``<name>.py`` in the
    package's directory (names that start with ``_`` left out). Asking
    for a name with no file raises ``LookupError`` naming the file and
    the directory it was looked for in."""

    def __init__(self, package: str, attr: str):
        self.directory = Path(importlib.import_module(package).__file__) \
            .parent
        super().__init__(
            (p.stem, getattr(importlib.import_module(f"{package}.{p.stem}"),
                             attr))
            for p in sorted(self.directory.glob("*.py"))
            if not p.stem.startswith("_"))

    def __missing__(self, name: str):
        raise LookupError(f"no file {name}.py in {self.directory} for "
                          f"{name!r} (it has {sorted(self)})")
