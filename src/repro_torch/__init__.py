"""PyTorch/CUDA port of the LiFE solver (the JAX package ``repro`` is the
reference).

The layout mirrors ``repro``: ``core/`` holds the STD data types, the plain
SpMV executors, the inspector, the SBBNNLS solver, the executor registry,
the plan cache and the single-subject and cohort engines; ``data/`` the
synthetic connectome generator and token stream; ``formats/`` the Phi
layouts and their selection; ``tune/`` the kernel autotuner;
``checkpoint/`` solver-state and training-state checkpoints; ``obs/``
metrics and span tracing, wired into the engines, the plan cache, the
tuner and the service; ``roofline/`` the H100's
roofline terms and the SpMVs' compulsory bytes; ``serve/`` the
multi-tenant solve service; ``kernels/`` the hand-written CUDA kernels for
Hopper (``kernels/csrc``) with their wrappers and plain PyTorch versions;
``configs/``, ``models/``, ``optim/``, ``data/tokens.py`` and ``launch/``
the LM side-workload: serving and training the dense, MoE, ssm and
hybrid families, at any sequence length.
``bridge`` carries problems, weights and states across from the reference
as numpy arrays.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no device asked for they raise
(:func:`repro_torch.device.resolve_device`).
"""
