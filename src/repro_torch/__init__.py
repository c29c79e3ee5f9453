"""PyTorch/CUDA port of the distance-query system.

A second package beside the JAX package ``repro``, which stays the
reference: the same Border Labeling index, edge servers and §4.2
request plane, with the serving joins run by hand-written CUDA kernels
on an NVIDIA H100 (``kernels/*/csrc``, built at first use). It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.

    from repro_torch.core import bfs_grow_partition, grid_road_network
    from repro_torch.edge import EdgeSystem

    g = grid_road_network(12, 12, seed=0)
    system = EdgeSystem.deploy(g, bfs_grow_partition(g, 6, seed=0))
    batch = system.service().submit(ss, ts)
"""
