"""Checkpoints of solver states (torch counterpart of ``repro/checkpoint``):
:mod:`repro_torch.checkpoint.manager`."""
