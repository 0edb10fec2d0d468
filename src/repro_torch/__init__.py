"""PyTorch/CUDA port of the rotor checkpointing system, for one NVIDIA H100.

The package mirrors the module names of the JAX package ``repro`` so that each
module's counterpart is easy to find, but it imports neither ``jax`` nor
anything of ``repro``: the numpy-only pieces it needs are kept here as copies.
Every kernel on the training path is written by hand for Hopper, in CUDA
C++ for ``sm_90a`` under ``kernels/csrc/``; each wrapper runs its kernel on
CUDA tensors and its plain PyTorch version on CPU or meta tensors.
"""
