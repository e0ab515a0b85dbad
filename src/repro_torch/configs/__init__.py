"""Architecture configurations of the LM side-workload (the port runs the
dense and MoE families; see :data:`repro_torch.configs.base.PORTED`)."""
