"""PyTorch + CUDA port of the FLASH-FHE reproduction.

``repro_torch`` runs the CKKS and BGV paths and the multi-job executor of the
reference package (``repro``) on an NVIDIA H100 through hand-written CUDA
kernels, and on the CPU through their plain PyTorch versions.  It imports
neither JAX nor the reference package.
"""
