"""Kernel packages of the port: each holds a CUDA kernel's wrapper (``ops``) and its plain PyTorch version (``ref``)."""
