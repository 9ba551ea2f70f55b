"""PyTorch/CUDA port of the Comet MoE system (``repro``), slice by slice.

Plain tensor code is PyTorch; the TPU's Pallas kernels on the serving and
training paths are hand-written CUDA kernels for Hopper
(``kernels/csrc``). The package imports neither ``jax`` nor ``repro``.
"""
