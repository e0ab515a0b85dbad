"""The LM side-workload's models: layers, flash attention, the MoE layer
(expert products on kernel B7), the Mamba2 layer and the transformer's
training forward, prefill and decode."""
