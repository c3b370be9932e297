"""PyTorch/CUDA port of the FL-APU reproduction (``repro``).

Mirrors ``src/repro/``'s layout module by module. The port imports
``torch`` and never ``jax``, and nothing of the ``repro`` package: the
JAX package stays as the reference the port is tested against
(``tests/test_torch_*.py``), and every framework-free piece the port
needs is copied here.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``); without CUDA they raise instead of
falling back. Hand-written Hopper kernels live in ``csrc/`` and are bound
through ``kernels/_build.py``.
"""
