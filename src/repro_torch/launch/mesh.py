"""Production mesh construction and the card's peak rates.

The port of the JAX package's ``launch/mesh.py``. A JAX mesh is read by
the sharding rules only through its axis names and sizes, so the port's
production mesh is ``AbstractMesh``: names and sizes, no devices (what
``jax.sharding.AbstractMesh`` is). ``to_device_mesh`` turns one into a
``torch.distributed`` ``DeviceMesh`` where a process group of that many
ranks exists. ``make_edge_mesh`` is the edge layout's
``edge/sharded_oracle.py::default_edge_mesh``.

The constants are an H100 SXM's, where the reference's are a TPU v5e's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# NVIDIA H100 SXM, from NVIDIA's H100 Tensor Core GPU data sheet (dense
# rates, no sparsity, at the part's 700 W): bf16 / fp16 on the tensor
# cores, float32 outside them, HBM3, and NVLink 4's 900 GB/s total over
# 18 links, i.e. 25 GB/s each way a link. A card set to a lower power
# limit runs slower under load: print `nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader` beside any number
# set against these.
PEAK_FLOPS_BF16 = 989e12        # per card
PEAK_FLOPS_F32 = 67e12          # per card, outside the tensor cores
HBM_BW = 3.35e12                # bytes/s per card
ICI_BW = 25e9                   # bytes/s per NVLink link, one way
NVLINK_LINKS = 18               # links per card


@dataclass(frozen=True)
class AbstractMesh:
    """A device mesh's axis names and sizes, and nothing else: the duck
    type the sharding rules read (``axis_names``, ``shape[name]``,
    ``size``)."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_edge_mesh(num_devices: int | None = None, device=None):
    """1-D mesh for the districts→devices distance-query deployment (an
    ``EdgeMesh``; ``device`` None = the CUDA card)."""
    from ..edge.sharded_oracle import default_edge_mesh
    return default_edge_mesh(num_devices, device=device)


def to_device_mesh(mesh: AbstractMesh, device_type: str):
    """``mesh`` as a ``torch.distributed`` ``DeviceMesh`` of that shape and
    those dim names. Needs an initialised default process group whose
    world size is ``mesh.size``; raises otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("to_device_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh {mesh.size} devices")
    return init_device_mesh(device_type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)
