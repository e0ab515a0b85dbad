"""Synthetic dMRI / tractography problems and the synthetic token
stream."""
