"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``csrc/*.cu`` hold the kernels; ``_build`` compiles them with ``nvcc`` for
``sm_90a`` at first use and loads them with ``ctypes``; ``dsc`` and ``wc``
hold each kernel's wrapper, launch counter and plain PyTorch version;
``ops`` binds a ``TilePlan`` to them; ``ref`` holds the per-tile oracles.
"""
