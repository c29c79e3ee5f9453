"""Min-plus (tropical) products — the tiled product and the fused
Bellman-Ford sweep of the Border-Labeling builder: CUDA kernels, plain
PyTorch versions and the public entry points."""
