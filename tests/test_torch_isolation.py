"""The port stands alone: no JAX, nothing of ``repro``, no quiet CPU.

* every ``repro_torch`` module, and ``chip_smoke.py``, imports in a
  process where ``import jax`` fails, and loads no ``repro`` module;
* entry points default to the CUDA device and raise without one;
* a CUDA tensor handed to the kernel wrapper launches or raises — it
  never runs the plain version;
* ``chip_smoke.py`` exits non-zero without a card, and in a directory
  that holds nothing else of the repository.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (DistanceOracle, bfs_grow_partition,
                              grid_road_network)
from repro_torch.edge import (BatchedQueryEngine, ComputingCenter, EdgeSystem,
                              ShardedBatchedEngine, default_edge_mesh)
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.label_join import kernel, ops
from repro_torch.kernels.minplus import kernel as mp_kernel
from repro_torch.kernels.sssp_relax import kernel as fw_kernel
from repro_torch.models import lm
from repro_torch.serve import BatchedDecoder
from repro_torch.update import IncrementalBuilder

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None              # any `import jax` now fails
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
loaded = sorted(k for k in sys.modules
                if k == "repro" or k.startswith("repro."))
assert not loaded, loaded
assert sys.modules["jax"] is None
print("IMPORTED", len([k for k in sys.modules
                       if k.startswith("repro_torch")]))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT)],
                         env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    # 91 modules: the serving path, the staged builder, the configs, the
    # dense LM (models, train, launch, kernels/flash_attention), the
    # updates (update/delta, update/scenarios, topo), Floyd–Warshall
    # (kernels/sssp_relax/kernel), the oracle API, the sharded layouts,
    # the scatter-gather plane, faults, simulator and load harness, the
    # DIMACS ingest (ingest/dimacs, ingest/datasets) and the training
    # path (train/optimizer, train/data, train/loop, distributed,
    # launch/train, tree), the MoE layer (models/moe) and the launch and
    # sharding tooling (launch/mesh, specs, dryrun, roofline,
    # distributed/sharding, act_sharding)
    assert int(out.stdout.split("IMPORTED")[1]) >= 97


_IMPORT_NEW = r"""
import importlib, sys
sys.modules["jax"] = None              # any `import jax` now fails
for name in sys.argv[1:]:
    importlib.import_module(name)
loaded = sorted(k for k in sys.modules
                if k == "repro" or k.startswith("repro."))
assert not loaded, loaded
assert sys.modules["jax"] is None
print("OK")
"""

# the modules of the updates slice and of the Floyd–Warshall kernel, then
# (one process for the lot) those of the oracle API and the sharded
# layouts, (one more) those of the scatter-gather read path, the
# faults, the simulator and the load harness, (two more) those of the
# DIMACS ingest and of the training path, (one more) the MoE and MLA
# modules, and (one more) the launch and sharding tooling
UPDATE_MODULES = ["repro_torch.update.delta", "repro_torch.update.scenarios",
                  "repro_torch.update.incremental", "repro_torch.update",
                  "repro_torch.topo.structural", "repro_torch.topo",
                  "repro_torch.ingest.synth",
                  "repro_torch.kernels.sssp_relax.ref",
                  "repro_torch.kernels.sssp_relax.kernel",
                  "repro_torch.kernels.sssp_relax.ops",
                  "repro_torch.edge.center", "repro_torch.edge.router",
                  "repro_torch.core.oracle repro_torch.core.query "
                  "repro_torch.core.local_index repro_torch.topo.rebalance "
                  "repro_torch.edge.sharded_oracle repro_torch.edge.engine "
                  "repro_torch.serve.service",
                  "repro_torch.edge.topology repro_torch.edge.traffic "
                  "repro_torch.edge.faults repro_torch.edge.scatter_gather "
                  "repro_torch.edge.simulator repro_torch.serve.loadgen "
                  "repro_torch.serve.distance_batcher",
                  "repro_torch.ingest.dimacs repro_torch.ingest.datasets "
                  "repro_torch.core.graph",
                  "repro_torch.train.optimizer repro_torch.train.data "
                  "repro_torch.train.loop repro_torch.train.train_step "
                  "repro_torch.distributed.checkpoint "
                  "repro_torch.distributed.compression "
                  "repro_torch.launch.train repro_torch.tree",
                  "repro_torch.models.moe repro_torch.models.attention "
                  "repro_torch.models.lm",
                  "repro_torch.launch.mesh repro_torch.launch.specs "
                  "repro_torch.launch.dryrun repro_torch.launch.roofline "
                  "repro_torch.distributed.sharding "
                  "repro_torch.distributed.act_sharding"]


@pytest.mark.parametrize("module", UPDATE_MODULES)
def test_update_modules_import_alone_without_jax(module):
    out = subprocess.run([sys.executable, "-c", _IMPORT_NEW,
                          *module.split()],
                         env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "OK"


def _require_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts "
                    "without one")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _require_cpu_only_host()
    g = grid_road_network(4, 4, seed=0)
    part = bfs_grow_partition(g, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EdgeSystem.deploy(g, part)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedQueryEngine(np.zeros((16, 0), np.float32), [],
                           part.assignment)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IncrementalBuilder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputingCenter(g, part, builder="torch")
    for arch in ("qwen3_4b", "olmoe_1b_7b", "deepseek_v2_236b",
                 "internvl2_26b", "hubert_xlarge"):
        cfg = get_smoke_config(arch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_params(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_cache(cfg, 1, 8)
        if cfg.supports_decode():         # HuBERT is encoder-only
            with pytest.raises(RuntimeError, match="no CUDA device"):
                BatchedDecoder(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistanceOracle.build(g, part)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_edge_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedBatchedEngine(np.zeros((16, 0), np.float32), [],
                             part.assignment)


def test_training_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    _require_cpu_only_host()
    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.launch import train as launch_train
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.train.optimizer import OptimizerConfig
    cfg = get_smoke_config("qwen3_4b")
    save_checkpoint(str(tmp_path), 1, {"t": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(cfg, OptimizerConfig(), DataConfig(8, 1),
                     LoopConfig(checkpoint_dir=str(tmp_path / "x")),
                     lambda: {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3_4b", "--smoke", "--ckpt",
                           str(tmp_path / "y")])


class _CudaLooking(torch.Tensor):
    """A host tensor that reports the CUDA device: what the wrapper sees
    for a tensor on the card, on a host that has none."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("with_lb", [False, True])
def test_cuda_tensor_launches_or_raises_never_falls_back(monkeypatch,
                                                         with_lb):
    _require_cpu_only_host()

    def no_fallback(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(kernel, "gather_join_ref", no_fallback)
    monkeypatch.setattr(kernel.build, "_LOADED", {})
    monkeypatch.setenv("PATH", "")           # no nvcc on this host anyway
    table = torch.zeros((6, 4)).as_subclass(_CudaLooking)
    rows = torch.arange(3).as_subclass(_CudaLooking)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.gather_join(table, rows, table, rows, with_lb=with_lb)
    assert kernel.LAUNCHES == before


@pytest.mark.parametrize("codes", [False, True])
def test_cuda_tensor_launches_or_raises_never_falls_back_sharded(
        monkeypatch, codes):
    _require_cpu_only_host()

    def no_fallback(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(kernel, "sharded_gather_join_ref", no_fallback)
    monkeypatch.setattr(kernel, "multi_shard_gather_join_ref", no_fallback)
    monkeypatch.setattr(kernel.build, "_LOADED", {})
    monkeypatch.setenv("PATH", "")           # no nvcc on this host anyway
    dtype = torch.int16 if codes else torch.float32
    block = torch.zeros((6, 4), dtype=dtype).as_subclass(_CudaLooking)
    border = torch.zeros((6, 3), dtype=dtype).as_subclass(_CudaLooking)
    ids = torch.arange(3).as_subclass(_CudaLooking)
    quant = (0xFFFF, 0.5) if codes else None
    before = dict(kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.sharded_gather_join(block, border, ids, 0, ids, ids,
                                   quant=quant)
    # the whole-batch wrapper: B replicated, row-sharded, and (codes)
    # dequantized first
    for kw in ({}, {"rows_per_border_shard": 6},
               *([{"dequant_first": True}] if codes else [])):
        with pytest.raises(RuntimeError, match="nvcc"):
            kernel.multi_shard_gather_join([block, block], [border, border],
                                           ids, ids, ids, quant=quant, **kw)
    assert kernel.LAUNCHES == before


@pytest.mark.parametrize("name", ["minplus", "relax"])
def test_cuda_tensor_launches_or_raises_never_falls_back_minplus(
        monkeypatch, name):
    _require_cpu_only_host()

    def no_fallback(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(mp_kernel, "minplus_ref", no_fallback)
    monkeypatch.setattr(mp_kernel, "relax_ref", no_fallback)
    monkeypatch.setattr(mp_kernel.build, "_LOADED", {})
    monkeypatch.setenv("PATH", "")           # no nvcc on this host anyway
    x = torch.zeros((2, 4, 4)).as_subclass(_CudaLooking)
    before = dict(mp_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        getattr(mp_kernel, name)(x, x)
    assert mp_kernel.LAUNCHES == before


@pytest.mark.parametrize("n", [1, 33, 130])
def test_cuda_tensor_launches_or_raises_never_falls_back_fw(monkeypatch, n):
    _require_cpu_only_host()

    def no_fallback(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(fw_kernel, "floyd_warshall_ref", no_fallback)
    monkeypatch.setattr(fw_kernel.build, "_LOADED", {})
    monkeypatch.setenv("PATH", "")           # no nvcc on this host anyway
    adj = torch.zeros((n, n)).as_subclass(_CudaLooking)
    before = dict(fw_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        fw_kernel.floyd_warshall(adj)
    assert fw_kernel.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tensor_launches_or_raises_never_falls_back_flash(
        monkeypatch, dtype):
    _require_cpu_only_host()

    def no_fallback(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(fa_kernel, "attention_ref", no_fallback)
    monkeypatch.setattr(fa_kernel.build, "_LOADED", {})
    monkeypatch.setenv("PATH", "")           # no nvcc on this host anyway
    q = torch.zeros((1, 8, 4, 32), dtype=dtype).as_subclass(_CudaLooking)
    kv = torch.zeros((1, 8, 2, 32), dtype=dtype).as_subclass(_CudaLooking)
    before = dict(fa_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa_kernel.flash_attention(q, kv, kv)
    assert fa_kernel.LAUNCHES == before


def test_ops_on_an_unsupported_device_raise():
    table = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.gather_join(table, torch.zeros(2, dtype=torch.int64,
                                              device="meta"),
                           table, torch.zeros(2, dtype=torch.int64,
                                              device="meta"))
    with pytest.raises(ValueError):
        EdgeSystem.deploy(grid_road_network(3, 3), None, device="meta")
    with pytest.raises(TypeError, match="torch.Tensor"):
        ops.join_gathered(np.zeros((3, 2), np.float32), [0], [1])


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    _require_cpu_only_host()
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], env=_env(),
                             cwd=cwd, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_gpu_marker_is_registered(pytestconfig):
    assert any(m.startswith("gpu:")
               for m in pytestconfig.getini("markers"))
