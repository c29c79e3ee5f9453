"""Fused gather + 2-hop label join (λ and the Theorem-3 Local Bound):
CUDA kernel, plain PyTorch version and the serving entry points."""
