"""Flags of the port: the ones its slices read, with the JAX package's
defaults.

Counterpart of ``paddle_tpu/flags.py`` (``set_flags``, ``get_flag``).
Only the flags that a ported path reads live here (generation and
quantization, the Predictor and its pool, dropout, the embedding
gradient, the executor's checks, the dataset loop, the rendezvous and the
gradient wire of data parallelism); a later slice adds its own. An unknown name raises in ``set_flags`` and ``get_flags``, as in
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
    # the paged-attention form of the generation engine: "pallas" names
    # the Hopper kernel (on a CPU tensor its wrapper runs the plain
    # version); "reference", the JAX package's default, is accepted only
    # off the card (a plain version never runs on a CUDA tensor)
    "FLAGS_paged_attention_kernel": "pallas",
    # the program cache (core/program_cache.py): None follows
    # PADDLE_TPU_PROGRAM_CACHE_DIR, and without it there is no cache; ""
    # disables it
    "FLAGS_program_cache_dir": None,
    # adaptive dispatch (autotune.py): tune the engine's geometry and the
    # Predictor's bucket-or-exact choice once a key; at most
    # autotune_candidates forms, a probe of autotune_probe_tokens tokens
    "FLAGS_autotune": False,
    "FLAGS_autotune_candidates": 4,
    "FLAGS_autotune_probe_tokens": 32,
    # what the JAX dropout backward stores ("xla", "u8", "seed"); the
    # port's dropout gives the same Out and Mask under each value
    "FLAGS_dropout_storage": "xla",
    # the JAX package's one-hot embedding gradient; the port sums the
    # same rows with its fixed-order gradient (nn/functional.py) either way
    "FLAGS_embedding_onehot_grad": True,
    # the distributed runtime (parallel/env.py): each rendezvous attempt's
    # timeout, the retries after a failed one, and the first backoff
    # (doubled each retry); a group that cannot form inside the budget
    # raises RendezvousTimeout
    "FLAGS_rendezvous_timeout_s": 60.0,
    "FLAGS_rendezvous_retries": 2,
    "FLAGS_rendezvous_backoff_ms": 200.0,
    # the mesh a plan is built on when none is installed ("dp2"; "" none)
    "FLAGS_mesh_spec": "",
    # the data-parallel gradient wire (mesh/collectives.py): "off" averages
    # the step's gradients once in fp32 buckets, "fp32" once a microbatch,
    # "int8" and "fp8" once a step on the block-scaled quantized wires
    "FLAGS_collective_quant": "off",
    # a bucket's cap in MiB of fp32 payload
    "FLAGS_collective_bucket_mb": 4,
    # gradients with fewer elements (or ndim <= 1) stay on the fp32 wire
    "FLAGS_collective_quant_min_numel": 2048,
    # the wire of mesh-sharded parameters: only "off" here, the tensor-
    # parallel half of the runtime is not ported (ROADMAP.md A6)
    "FLAGS_collective_quant_mp": "off",
}

_values: Dict[str, Any] = dict(_DEFS)
# the names ever passed through set_flags: autotune takes an explicitly
# set geometry flag as a pin, which its value alone cannot tell
_EXPLICIT: set = set()


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
        _EXPLICIT.add(k)


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


def explicitly_set(name: str) -> bool:
    """True when the flag was ever set through ``set_flags``."""
    return _canon(name) in _EXPLICIT


def clear_explicit(*names: str) -> None:
    """Forget that ``names`` (every flag when none) were set explicitly;
    their values stay."""
    if not names:
        _EXPLICIT.clear()
    for n in names:
        _EXPLICIT.discard(_canon(n))


# the flags a lowering reads: their values are part of what a traced
# program computes, so Program.fingerprint hashes them
LOWERING_FLAGS = ("FLAGS_check_nan_inf", "FLAGS_dropout_storage",
                  "FLAGS_embedding_onehot_grad", "FLAGS_quant_mode",
                  "FLAGS_generation_kv_quant",
                  "FLAGS_paged_attention_kernel")


def lowering_snapshot() -> tuple:
    """Sorted (name, value) pairs of ``LOWERING_FLAGS``."""
    return tuple((k, _values.get(k)) for k in sorted(LOWERING_FLAGS))
