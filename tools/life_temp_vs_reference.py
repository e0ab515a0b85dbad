"""The SBBNNLS step's temporary memory, compiled and traced: the
reference's ``make_sharded_step`` (``make_sharded_step_1d``) compiled by
XLA for the CPU on a one-device (1, 1) mesh (``memory_analysis()``'s
``temp_size_in_bytes``) beside the port's dry-run trace of an odd and an
even iteration of its own step at the same shapes
(``launch/dryrun.py:trace_life``'s ``peak_temp_bytes``).  The port's WC
keeps ``d[atoms]``, ``Y[voxels]`` and their product alive at once; this
shows what the XLA compiler of the CPU makes of the same WC.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/life_temp_vs_reference.py

Runs on the CPU (both packages), seconds; the last line is JSON.
"""
from __future__ import annotations

import argparse
import json

import jax
import numpy as np
from jax.sharding import Mesh

from repro.distributed import life_shard as JLS
from repro_torch.distributed import life_shard as LS
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import ShapeMesh


def main(argv=None) -> int:
    """Print both temp sizes for each variant as one JSON line."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--voxels", type=int, default=20_000)
    ap.add_argument("--fibers", type=int, default=5_000)
    ap.add_argument("--theta", type=int, default=96)
    ap.add_argument("--atoms", type=int, default=96)
    ap.add_argument("--nnz", type=int, default=200_000)
    args = ap.parse_args(argv)
    sizes = dict(n_voxels=args.voxels, n_fibers=args.fibers,
                 n_theta=args.theta, n_atoms=args.atoms, nnz=args.nnz)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    one = ShapeMesh((1, 1), ("data", "model"))
    out = {"sizes": sizes}
    for variant in ("2d", "1d"):
        if variant == "1d":
            specs = JLS.life_input_specs_1d(mesh, **sizes)
            step = JLS.make_sharded_step_1d(mesh, specs.pop("meta"))
            keys = ("a", "v", "fi", "vals", "d", "b", "w", "it")
            port = LS.life_input_specs_1d(one, **sizes)
        else:
            specs = JLS.life_input_specs(mesh, **sizes)
            step = JLS.make_sharded_step(mesh, specs.pop("meta"))
            keys = ("da", "dv", "df", "dw", "wa", "wv", "wf", "ww", "d", "b",
                    "w", "it")
            port = LS.life_input_specs(one, **sizes)
        with mesh:
            c = jax.jit(step).lower(*(specs[k] for k in keys)).compile()
        ops = LS.rank0_operands(port, variant)
        peaks = [D.trace_life(one, variant, ops, it).peak_temp_bytes
                 for it in (1, 2)]
        out[variant] = {"reference_temp": c.memory_analysis()
                        .temp_size_in_bytes,
                        "traced_peak_odd": peaks[0],
                        "traced_peak_even": peaks[1],
                        "wc_temporaries": 3 * args.nnz * args.theta * 4}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
