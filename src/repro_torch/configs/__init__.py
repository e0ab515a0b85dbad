"""Architecture configurations of the LM side-workload (the port runs the
MoE family; see :data:`repro_torch.configs.base.PORTED`)."""
