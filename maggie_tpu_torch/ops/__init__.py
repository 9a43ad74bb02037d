"""Ops of the port: resize, morphology, block-sparse machinery and CUDA kernels."""
