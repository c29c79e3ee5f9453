"""Hand-written CUDA kernels of the port (built from ``*/csrc`` at first
use, see ``build``) with their plain PyTorch versions."""
