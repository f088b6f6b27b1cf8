"""Hand-written Hopper kernels of the port and their plain PyTorch versions:
``layer_norm`` (fused layer-norm forward) and ``flash_attention``
(flash-attention forward). Sources are under ``paddle_tpu_torch/csrc``."""
