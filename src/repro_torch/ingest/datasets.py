"""Checksum-pinned registry of DIMACS challenge-9 road networks.

Tests and CI never touch the network — they run on the synthetic
continent (``ingest.synth``).  This registry exists so a human (or an
opt-in benchmark run) can pull the real USA extracts reproducibly:
every entry names the upstream URL and the published vertex/arc counts,
``fetch`` downloads only when explicitly called, and checksums make the
download reproducible across machines.

Upstream publishes no digests, so pinning is trust-on-first-use: a
spec may carry ``sha256=None``, in which case the first successful
``fetch`` computes the digest and writes it to a ``.sha256`` sidecar
next to the cached file; every later ``fetch`` (and any pre-existing
cache hit) is verified against the sidecar — or against the spec's
hash when one is pinned in code — and a mismatch deletes nothing
silently: it raises.

Cache location: ``$REPRO_DATA_DIR`` if set, else ``~/.cache/repro``.

A copy of ``repro.ingest.datasets``: the same registry, cache paths and
pinning, so one cache serves both packages.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import urllib.request
from dataclasses import dataclass

_BASE = ("https://www.diag.uniroma1.it/challenge9/data/USA-road-d/"
         "USA-road-d.{name}.gr.gz")


@dataclass(frozen=True)
class DatasetSpec:
    """One downloadable ``.gr.gz`` road network.

    ``sha256=None`` means "pin on first use" (upstream publishes no
    digests); a hex string means the fetch must match it exactly.
    """

    name: str          # registry key, e.g. "USA-road-d.NY"
    url: str
    num_vertices: int  # from the DIMACS challenge-9 tables
    num_arcs: int
    sha256: str | None = None

    @property
    def filename(self) -> str:
        return self.url.rsplit("/", 1)[-1]


def _usa(name: str, n: int, m: int) -> DatasetSpec:
    return DatasetSpec(f"USA-road-d.{name}", _BASE.format(name=name),
                       n, m)


# distance-weighted USA extracts, small to large (counts from the
# challenge-9 tables; digests are TOFU-pinned at first fetch)
DATASETS: dict[str, DatasetSpec] = {
    s.name: s for s in (
        _usa("NY", 264_346, 733_846),
        _usa("BAY", 321_270, 800_172),
        _usa("COL", 435_666, 1_057_066),
        _usa("FLA", 1_070_376, 2_712_798),
    )
}


def sha256_of(path, chunk: int = 1 << 20) -> str:
    """Streaming sha256 of a file on disk."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def cache_dir() -> pathlib.Path:
    root = os.environ.get("REPRO_DATA_DIR")
    if root:
        return pathlib.Path(root)
    return pathlib.Path.home() / ".cache" / "repro"


def dataset_path(name: str) -> pathlib.Path:
    """Local cache path for a registered dataset (no I/O)."""
    return cache_dir() / DATASETS[name].filename


def _sidecar(dest: pathlib.Path) -> pathlib.Path:
    return dest.with_suffix(dest.suffix + ".sha256")


def _pinned_digest(spec: DatasetSpec,
                   dest: pathlib.Path) -> str | None:
    if spec.sha256 is not None:
        return spec.sha256
    side = _sidecar(dest)
    if side.exists():
        return side.read_text().strip()
    return None


def fetch(name: str, force: bool = False) -> pathlib.Path:
    """**Opt-in** download of a registered dataset into the cache.

    Verifies against the pinned digest (spec or sidecar) when one
    exists; otherwise pins the digest of this first download into the
    sidecar.  Never called by tests or CI.
    """
    spec = DATASETS[name]
    dest = dataset_path(name)
    pinned = _pinned_digest(spec, dest)
    if dest.exists() and not force:
        got = sha256_of(dest)
        if pinned is None:
            _sidecar(dest).write_text(got + "\n")
        elif got != pinned:
            raise ValueError(
                f"cached {dest} has sha256 {got}, expected {pinned}; "
                "pass force=True to re-download")
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    with urllib.request.urlopen(spec.url) as resp, open(tmp, "wb") as out:
        while True:
            buf = resp.read(1 << 20)
            if not buf:
                break
            out.write(buf)
    got = sha256_of(tmp)
    if pinned is not None and got != pinned:
        tmp.unlink(missing_ok=True)
        raise ValueError(f"downloaded {spec.url} has sha256 {got}, "
                         f"expected {pinned}")
    tmp.replace(dest)
    if pinned is None:
        _sidecar(dest).write_text(got + "\n")
    return dest
