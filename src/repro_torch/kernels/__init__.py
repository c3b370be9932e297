"""Hand-written Hopper kernels for the compute hot spots.

Each kernel ships three modules, as in ``repro.kernels``:
  kernel.py — the ctypes binding of the CUDA kernel in ``csrc/``
  ops.py    — the public wrapper: checks, launch counter, and the plain
              version for tensors on the CPU
  ref.py    — the plain PyTorch version the kernel is held against

A wrapper takes the plain version only for a CPU tensor. For a CUDA
tensor it launches the kernel or raises.
"""
