"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``csrc/*.cu`` hold the kernels (B1 ``dsc``, B2 ``wc``, B3 ``dsc_sell``,
B4 ``wc_sell``, B5 ``dsc_fcoo``, B6 ``wc_fcoo``, B7 ``moe_gmm``); ``_build``
compiles them with ``nvcc`` for ``sm_90a`` at first use, loads them with
``ctypes`` and counts their launches; ``dsc``, ``wc``, ``fcoo`` and
``moe_gmm`` hold each kernel's wrapper and plain PyTorch version; ``ops``
binds plans and layouts to them; ``ref`` holds the per-tile oracles of the
COO kernels and B7's plain version.
"""
