"""PyTorch/CUDA port of the LiFE solver (the JAX package ``repro`` is the
reference).

The layout mirrors ``repro``: ``core/`` holds the STD data types, the plain
SpMV executors, the inspector, the SBBNNLS solver, the executor registry and
the engine; ``data/`` the synthetic connectome generator; ``kernels/`` the
hand-written CUDA kernels for Hopper (``kernels/csrc``) with their wrappers
and plain PyTorch versions.  ``bridge`` carries problems, weights and states
across from the reference as numpy arrays.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no device asked for they raise
(:func:`repro_torch.device.resolve_device`).
"""
