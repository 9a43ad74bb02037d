"""Hand-written CUDA kernels (sm_90a) with their plain PyTorch twins.

Each wrapper launches its kernel for a CUDA tensor and runs the twin for a CPU
tensor. Kernels are built from ``csrc/`` at first use (``build.py``).
"""
