"""Architecture configurations of the LM side-workload (the port runs the
dense, MoE, ssm and hybrid families; see
:data:`repro_torch.configs.base.PORTED`)."""
