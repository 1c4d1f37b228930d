"""Tensor ops of the port: RoPE and the paged-attention kernel."""
