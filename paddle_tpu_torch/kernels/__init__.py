"""Hand-written Hopper kernels of the port and their plain PyTorch versions:
``layer_norm`` (fused layer norm, forward and backward) and
``flash_attention`` (flash attention, forward with dropout, dQ and dK/dV)
and ``paged_attention`` (ragged paged attention over fp32, int8 and fp8
KV pools).
Sources are under ``paddle_tpu_torch/csrc``."""
