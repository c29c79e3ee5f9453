"""Sharded, async checkpointing of tensor trees, in the JAX package's
on-disk format.

Layout: ``<dir>/step_<n>/shard_<k>.npz`` + ``manifest.json`` and a
``LATEST`` pointer. Each leaf is flattened to a named entry (``::``
between keys); arrays with at least ``num_shards`` rows are split along
axis 0 across the shards (``<name>@@<k>``), the rest go to shard 0. The
manifest records every entry's shards, dtype name and shape, and the
sha256 over the shard files; a save goes to a temp dir that is then
renamed, so a crash mid-save never moves ``LATEST`` to a partial step.
A checkpoint written by either package restores in the other.

bfloat16 leaves are stored as the reference stores its own: their 16-bit
patterns as ``V2`` arrays, named ``"bfloat16"`` in the manifest, which
is how a restore recognises them.
``restore_checkpoint`` takes ``device=`` where the reference takes
``shardings=``: the tree comes back as tensors on that device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..device import resolve_device

SEP = "::"


def _to_numpy(t: torch.Tensor | np.ndarray) -> np.ndarray:
    """A host copy (never a view: training updates tensors in place while
    an async save writes); bfloat16 as its 16-bit patterns (``V2``)."""
    if isinstance(t, np.ndarray):
        return t.copy()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str,
                device: torch.device) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict[str, Any]) -> Any:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def _save_host(directory: str, step: int, flat: dict[str, np.ndarray],
               num_shards: int) -> str:
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "num_shards": num_shards, "entries": {}}
    shards: list[dict[str, np.ndarray]] = [dict() for _ in range(num_shards)]
    for name, arr in sorted(flat.items()):
        if arr.ndim == 0 or arr.shape[0] < num_shards:
            shards[0][name] = arr
            ids = [0]
        else:
            pieces = np.array_split(arr, num_shards, axis=0)
            for k, piece in enumerate(pieces):
                shards[k][f"{name}@@{k}"] = piece
            ids = list(range(num_shards))
        manifest["entries"][name] = {"shards": ids,
                                     "dtype": _dtype_name(arr),
                                     "shape": list(arr.shape)}
    digest = hashlib.sha256()
    for k, shard in enumerate(shards):
        path = os.path.join(tmp, f"shard_{k}.npz")
        np.savez(path, **shard)
        _hash_file(path, digest)
    manifest["sha256"] = digest.hexdigest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(str(step))
    return final


def _hash_file(path: str, digest, chunk: int = 1 << 24) -> None:
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return
            digest.update(buf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    num_shards: int = 4) -> str:
    """Write ``tree`` (nested dicts of tensors or numpy arrays) as
    ``<directory>/step_<step>`` and point ``LATEST`` at it; returns the
    step's directory."""
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    return _save_host(directory, step, flat, num_shards)


def latest_step(directory: str) -> int | None:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore_checkpoint(directory: str, step: int | None = None,
                       device: torch.device | str | None = None,
                       verify: bool = True) -> Any:
    """The tree saved at ``step`` (default: ``LATEST``) as tensors on
    ``device`` (None: the card). Raises ``IOError`` when the shards'
    sha256 differs from the manifest's (``verify``)."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    base = os.path.join(directory, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    paths = [os.path.join(base, f"shard_{k}.npz")
             for k in range(manifest["num_shards"])]
    if verify:
        digest = hashlib.sha256()
        for path in paths:
            _hash_file(path, digest)
        if digest.hexdigest() != manifest["sha256"]:
            raise IOError(f"checkpoint {base} failed hash verification")
    raw = [np.load(path) for path in paths]
    flat = {}
    try:
        for name, ent in manifest["entries"].items():
            if ent["shards"] == [0] and name in raw[0]:
                arr = raw[0][name]
            else:
                arr = np.concatenate(
                    [raw[k][f"{name}@@{k}"] for k in ent["shards"]], axis=0)
            flat[name] = _from_numpy(arr, ent["dtype"], device)
    finally:
        for r in raw:
            r.close()
    return _unflatten(flat)


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread (one in flight). ``save``
    copies the tree to the host before it returns, so the caller may
    update its tensors in place while the worker writes."""

    def __init__(self, directory: str, num_shards: int = 4):
        self.directory = directory
        self.num_shards = num_shards
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                _save_host(self.directory, step, flat, self.num_shards)
            except Exception as e:      # noqa: BLE001 — surfaced via wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
