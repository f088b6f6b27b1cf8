"""Flags of the port: the ones its slices read, with the JAX package's
defaults.

Counterpart of ``paddle_tpu/flags.py`` (``set_flags``, ``get_flag``).
Only the flags that a ported path reads live here (generation and
quantization, the Predictor and its pool, dropout, the embedding
gradient, the executor's checks and the dataset loop); a later slice adds
its own. An unknown name raises in ``set_flags`` and ``get_flags``, as in
the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Union

_DEFS: Dict[str, Any] = {
    # the executor's checks (core/executor.py): every float output of
    # every op, or one check of a run's fetches, for NaN/Inf; a warning
    # once a program about vars an op writes and nothing reads
    "FLAGS_check_nan_inf": False,
    "FLAGS_fast_check_nan_inf": False,
    "FLAGS_enable_unused_var_check": False,
    # train/infer_from_dataset: steps in flight (2: batch N+1 is staged
    # while step N runs; 1: stage, run, fetch in turn) and the batches
    # whose fetches are kept (0: all of them)
    "FLAGS_executor_inflight_steps": 2,
    "FLAGS_dataset_results_window": 0,
    # the generation engine (generation/engine.py): a fixed pool of
    # kv_blocks blocks of block_size tokens a layer (block 0 is the trash
    # block), decode_width lanes, prefill_chunk prompt tokens per lane and
    # step (chunked mode; 0 is the two-phase mode, whose whole-prompt
    # prefill pads to a rung of prefill_buckets), a mixed step of
    # token_budget slots (0: decode_width * (1 + spec_tokens) +
    # prefill_chunk)
    "FLAGS_generation_kv_blocks": 128,
    "FLAGS_generation_block_size": 16,
    "FLAGS_generation_decode_width": 8,
    "FLAGS_generation_prefill_buckets": "pow2:512",
    "FLAGS_generation_prefill_chunk": 8,
    "FLAGS_generation_token_budget": 0,
    "FLAGS_generation_prefix_cache": True,
    # speculative decoding: up to spec_tokens drafts a decode lane, from
    # the "ngram" prompt lookup or a "model" drafter, verified in one step
    "FLAGS_generation_spec_tokens": 0,
    "FLAGS_generation_draft": "ngram",
    "FLAGS_generation_queue_depth": 256,
    # weight quantization of the engine ("off", "int8", "fp8") and the
    # Predictor ("off", "int8")
    "FLAGS_quant_mode": "off",
    # KV pool dtype: "auto" follows FLAGS_quant_mode (int8 KV when the
    # weights are quantized, fp32 otherwise)
    "FLAGS_generation_kv_quant": "auto",
    # the Predictor's shape buckets (inference.py): comma-separated sizes
    # or "pow2:N"; a bucketed signature is one CUDA graph on the card
    "FLAGS_predictor_shape_buckets": "pow2:128",
    # PredictorPool (serving.py): coalesced-row cap, how long the batcher
    # holds an under-full batch, the bounded request-queue depth
    "FLAGS_predictor_max_batch": 32,
    "FLAGS_predictor_batch_timeout_ms": 2.0,
    "FLAGS_predictor_queue_depth": 256,
    # what the JAX dropout backward stores ("xla", "u8", "seed"); the
    # port's dropout gives the same Out and Mask under each value
    "FLAGS_dropout_storage": "xla",
    # the JAX package's one-hot embedding gradient; the port sums the
    # same rows with its fixed-order gradient (nn/functional.py) either way
    "FLAGS_embedding_onehot_grad": True,
}

_values: Dict[str, Any] = dict(_DEFS)


def _canon(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags by name; an unknown flag raises."""
    for k, v in flags.items():
        k = _canon(k)
        if k not in _values:
            raise ValueError(f"unknown flag {k!r} (the port knows "
                             f"{len(_values)} flags)")
        _values[k] = v


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, Any]:
    """The values of ``flags`` by their canonical names; an unknown flag
    raises."""
    out = {}
    for k in [flags] if isinstance(flags, str) else flags:
        k = _canon(k)
        if k not in _values:
            raise ValueError(f"unknown flag {k!r}")
        out[k] = _values[k]
    return out


def get_flag(name: str, default: Any = None) -> Any:
    return _values.get(_canon(name), default)
