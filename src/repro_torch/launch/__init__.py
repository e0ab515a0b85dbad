"""Launchers of the LM side-workload: the step builders and the serving
driver."""
