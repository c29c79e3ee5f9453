"""Shortest paths on dense district adjacencies: the blocked
Floyd–Warshall APSP (CUDA kernel, plain PyTorch version, public entry
point) and the multi-source relaxation of the staged builder's stage A
over the min-plus sweep kernel."""
