"""The mesh partition of LiFE (torch counterpart of ``repro/distributed``,
its LiFE half): cell meshes (``mesh.py``), the 2-D and 1-D SBBNNLS over
them (``life_shard.py``) and SPMD runs under ``torch.distributed``
(``spmd.py``)."""
