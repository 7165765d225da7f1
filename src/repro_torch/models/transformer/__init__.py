"""The LM transformer family of the port (serving): dense GQA attention
blocks with rope, and Mamba2 (SSD) blocks, assembled into a host-pipelined
prefill and decode. Counterpart of ``repro.models.transformer``."""
