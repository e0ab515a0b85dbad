"""The benchmark of the PyTorch and CUDA port of LiFE (``repro_torch``).

Run one cell from the root of a checkout::

    python3 -m life_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are named in ``BENCHMARK.json``;
each configuration, traffic mix, per-layer metric and set of correctness
limits is a file of its own under ``configs/``, ``traffic/``,
``metrics/`` and ``limits/``, found by name; a traffic file names its
driver in ``drivers/``.  Only the drivers import the port; nothing here
imports ``jax`` or the JAX package ``repro``.
"""
