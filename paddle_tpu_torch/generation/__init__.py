"""Autoregressive generation: paged KV cache, chunked or two-phase steps,
speculative decoding and continuous batching.

Counterpart of ``paddle_tpu/generation``:

- ``KVCacheManager`` keeps the ledger of a fixed, preallocated block pool
  (``FLAGS_generation_kv_blocks`` x ``FLAGS_generation_block_size``
  tokens a layer) with refcounted blocks and a prefix cache; sequences
  hold block tables, not buffers.
- ``GenerationEngine`` runs chunked mixed steps (decode lanes and prompt
  chunks share one forward over the pool, ``kernels/paged_attention.py``)
  or two phases (a bucketed whole-prompt prefill, then fixed-width decode
  steps), verifies the drafts of speculative decoding (ngram or model
  drafter) in its mixed step, serves int8/fp8 weights (``quant``), and
  samples greedy, top-k and top-p tokens keyed by (seed, step).
- ``GenerationPool`` admits requests into the running batch every step,
  with ``ServingQueueFull`` backpressure and per-request error isolation.
"""
from .engine import (GenerationEngine, GenerationRequest, GenerationResult,
                     NaiveGenerator)
from .kv_cache import TRASH_BLOCK, BlockPoolExhausted, KVCacheManager
from .model import DecoderConfig, forward_full, forward_paged, init_params
from .sampling import SamplingParams, sample_tokens
from .scheduler import GenerationPool

__all__ = [
    "BlockPoolExhausted", "DecoderConfig", "GenerationEngine",
    "GenerationPool", "GenerationRequest", "GenerationResult",
    "KVCacheManager", "NaiveGenerator", "SamplingParams", "TRASH_BLOCK",
    "forward_full", "forward_paged", "init_params", "sample_tokens",
]
