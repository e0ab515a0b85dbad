"""life-stn96 — the paper's own application: LiFE/SBBNNLS over an STN96-like
connectome (Ntheta=96).  Not an LM: ``models.transformer.Transformer``
refuses its family, and the dry run (``launch/dryrun.py``) records the
SBBNNLS iteration over the 2-D (voxel x fiber) mesh partition in place of
train/serve steps."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="life-stn96", family="life",
    n_layers=0, d_model=96,          # d_model doubles as Ntheta
))
