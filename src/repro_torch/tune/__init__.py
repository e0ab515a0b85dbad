"""Runtime measurement shared by every search (torch counterpart of
``repro/tune``).  This slice carries the measurement loop
(:mod:`repro_torch.tune.search`); the kernel autotuner arrives with the
tuning slice (ROADMAP A7)."""
