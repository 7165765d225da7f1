"""PyTorch/CUDA port of the pipe-parallel GNN system.

The package mirrors the JAX package's layout (``graphs/``, ``kernels/``,
``models/``, ``core/``, ``launch/``) so each module has a counterpart of the
same name. It imports ``torch`` and never ``jax``; framework-free logic
(dataset generators, partition layouts) is kept as its own copy.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; with no card
and no such request they raise. Hand-written CUDA kernels live beside their
plain PyTorch versions under ``kernels/``: a CUDA tensor takes the kernel, a
CPU tensor takes the plain version.
"""
