"""Launchers of the LM side-workload: the step functions, the serving
CLI and the trainer."""
