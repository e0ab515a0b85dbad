"""Architecture configurations: the LM side-workload's (the dense, MoE,
ssm, hybrid, audio and vlm families; see
:data:`repro_torch.configs.base.PORTED`) and life-stn96, the LiFE
workload the dry run reads."""
