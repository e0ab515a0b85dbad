"""Synthetic dMRI / tractography problems."""
