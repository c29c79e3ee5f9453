"""Hand-written CUDA kernels of the port (built from ``*/csrc`` at first
use, see ``build``) with their plain PyTorch versions:

* ``label_join`` — the fused gather + 2-hop label join (serving);
* ``minplus`` — the tiled min-plus product and the fused Bellman-Ford
  sweep (the staged builder's stages A–C);
* ``sssp_relax`` — the blocked Floyd–Warshall APSP (the per-district
  APSP entry point) and the multi-source relaxation over the sweep
  kernel;
* ``flash_attention`` — GQA online-softmax attention (LM prefill)."""
