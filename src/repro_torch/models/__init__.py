"""The LM side-workload's models: layers, the MoE layer (expert products on
kernel B7) and the transformer's prefill and decode."""
