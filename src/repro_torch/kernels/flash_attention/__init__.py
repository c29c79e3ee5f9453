"""GQA flash attention: the hand-written CUDA kernel (``csrc``), its
plain PyTorch version (``ref``) and the public entry point (``ops``)."""
