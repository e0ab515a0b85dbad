"""Roofline terms on the H100 (:mod:`repro_torch.roofline.analysis`) and
the LiFE SpMVs' compulsory bytes (:mod:`repro_torch.roofline.spmv_bytes`),
torch counterpart of ``repro/roofline``."""
