"""Optimizers of the LM training path (torch counterpart of
``repro/optim``)."""
