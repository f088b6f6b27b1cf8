"""GenerationEngine: continuous batching over the paged KV cache, in
chunked mixed steps or in two phases, with speculative decoding and
quantized weights.

Counterpart of ``paddle_tpu/generation/engine.py``. The engine owns the
device state (the parameters and the per-layer K/V block pools) and
``decode_width`` lanes.

- Chunked mode (``FLAGS_generation_prefill_chunk`` > 0, the default):
  every step runs one mixed forward over a fixed ``token_budget`` of
  slots: each decoding lane's next token first (decode never waits for a
  prefill), then up to ``prefill_chunk`` prompt tokens for each prefilling
  lane, in lane order; unused slots spin on the trash block
  (``STAT_generation_pad_tokens``). A sequence is admitted with blocks for
  its whole prompt and first token, streams its prompt in chunk by chunk
  while the other lanes decode, samples its first token from the last
  chunk's last slot, decodes one token a step, and leaves at EOS or
  max_new_tokens.
- Two-phase mode (``prefill_chunk=0``): admission runs the whole prompt
  through ``forward_full``, padded to a rung of the bucket ladder
  (``FLAGS_generation_prefill_buckets``) at the engine's ``attn_lanes``,
  writes its K/V rows into the pool over the whole bucket and samples the
  first token at step 0; each step then decodes one token in every lane
  (``decode_width`` slots of ``forward_paged``).
- Prefix cache (``FLAGS_generation_prefix_cache``, chunked mode):
  admission attaches the longest cached chunk-aligned prefix read-only and
  starts prefill at the first uncached chunk; completed chunk boundaries
  are published back. A write into a still-shared block copies it first
  (copy-on-write: the ledger swaps in a private block, ``_copy_block``
  copies its rows in every layer, scale pools and draft pools included).
- Speculative decoding (``FLAGS_generation_spec_tokens`` = k > 0, chunked
  mode): a drafter proposes up to k tokens a decode lane, the "ngram"
  prompt lookup on the host or a "model" drafter with its own fp32 pools
  under the same block tables, and the same mixed step verifies them: a
  decode lane with 1 + k slots at positions ctx..ctx+k. Slot j samples
  with the lane's own (seed, token index), so its token is the one plain
  decode would give iff every earlier draft matched; the host emits tokens
  up to the first mismatch. Rejected drafts' K/V rows lie past the
  accepted length, masked until overwritten. A drafter that raises
  degrades the step to plain decode (``STAT_generation_draft_faults``).
- Weights: ``quant_mode`` "int8" or "fp8" quantizes fp32 parameters in
  the process (a checkpoint already quantized passes through) and the
  KV dtype "auto" then resolves to int8; ``GAUGE_quant_weight_bytes_saved``
  reports the saving.
- Pool pressure: cold cached prefixes are evicted LRU-first, then the
  youngest sequence is preempted and re-queued at the front; sampling is
  a pure function of (logits, seed, step), so its replay regenerates the
  same tokens.
- KV dtype: fp32 pools, or int8/fp8 pools with per-token-per-head fp32
  scale pools (initialised to one, so a never-written row dequantizes to
  exact 0), chunked mode only.

There is no compiled-step registry: eager PyTorch runs each step as it
comes, and ``warmup`` runs every step kind once so the kernels are built
before the first request. The engine runs on the card unless the caller
asks for ``device="cpu"``; without CUDA the default raises. Not ported
yet, and refused with ``NotImplementedError`` naming ``ROADMAP.md`` A5:
``autotune``, ``program_cache_dir`` and the ``kernel=`` form (on the port
the device picks the path). Failpoints are omitted (A7).

Instruments: STAT_generation_requests / _tokens / _prefills /
_evictions / _errors / _pad_tokens / _replay_retries,
STAT_generation_prefix_{hits,misses,hit_tokens,cow_copies},
STAT_generation_spec_{proposed,accepted} / _draft_faults,
STAT_generation_kv_quant_blocks, GAUGE_generation_active_seqs,
GAUGE_kv_bytes_per_seq / _capacity_seqs, GAUGE_quant_weight_bytes_saved,
TIMER_generation_mixed_step_us (also as _decode_step_us, the two-phase
step's timer), _prefill_us, _inter_token_us and _prefix_admit_us; each
request carries a ``tracing.RequestTrace``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import quant as _quant
from .. import tracing as _tr
from ..device import DeviceLike, resolve
from ..flags import get_flag
from ..monitor import gauge_set, stat_add, timer_observe
from .kv_cache import (TRASH_BLOCK, BlockPoolExhausted, KVCacheManager,
                       PrefixCache)
from .model import DecoderConfig, forward_full, forward_paged
from .sampling import SamplingParams, sample_tokens

__all__ = ["GenerationEngine", "GenerationRequest", "GenerationResult",
           "NaiveGenerator", "bucket_for", "parse_bucket_ladder"]

# consecutive transient re-admission failures a replayed (preempted)
# request survives before it is failed
_REPLAY_ADMIT_RETRIES = 8


def parse_bucket_ladder(spec) -> List[int]:
    """A bucket ladder from a list of sizes, a comma string or "pow2:N"
    (powers of two up to N): sorted and deduplicated; empty for None.
    A copy of ``paddle_tpu/inference.py:parse_bucket_ladder``."""
    if spec is None:
        return []
    if isinstance(spec, (list, tuple)):
        ladder = [int(x) for x in spec]
    else:
        s = str(spec).strip()
        if not s:
            return []
        if s.startswith("pow2:"):
            cap = int(s[len("pow2:"):])
            ladder, b = [], 1
            while b <= cap:
                ladder.append(b)
                b *= 2
        else:
            ladder = [int(x) for x in s.split(",") if x.strip()]
    return sorted({b for b in ladder if b > 0})


def bucket_for(n: int, ladder: Sequence[int]) -> Optional[int]:
    """The smallest bucket >= n, or None past the ladder's top."""
    for b in ladder:
        if b >= n:
            return b
    return None


@dataclass
class GenerationRequest:
    """One decoding job. ``trace`` is the request's RequestTrace, set by
    GenerationPool.submit or opened by engine.submit; callers never set
    it."""
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: Any = None
    trace: Any = field(default=None, repr=False, compare=False)


@dataclass
class GenerationResult:
    request_id: Any
    prompt_len: int
    tokens: List[int]              # generated ids (no prompt, no EOS)
    finish_reason: str             # "eos" | "length"
    evictions: int = 0             # times this request was replayed


class _Seq:
    """Host-side state of one in-flight sequence."""

    __slots__ = ("req", "ctx", "generated", "lane", "admit_order",
                 "evictions", "t_last_token", "prefilled",
                 "admit_failures", "pkeys", "published")

    def __init__(self, req: GenerationRequest, admit_order: int):
        self.req = req
        self.ctx = 0               # tokens currently in the KV pool
        self.generated: List[int] = []
        self.lane = -1
        self.admit_order = admit_order
        self.evictions = 0
        self.t_last_token = time.perf_counter()
        self.prefilled = 0         # prompt tokens already in the pool
        self.admit_failures = 0    # consecutive transient re-admit fails
        self.pkeys = None          # [(boundary, hash)] of the prefix cache
        self.published = 0         # prompt tokens already cached


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to paddle_tpu_torch "
                               f"yet (ROADMAP.md {item})")


class GenerationEngine:
    """Continuous-batching decode engine over the paged KV cache.

    ``submit()`` queues a request, ``step()`` runs one mixed (or two-phase
    decode) step and returns the requests that finished, ``generate()``
    runs a batch to completion. Not thread-safe: ``GenerationPool`` is the
    concurrent front end."""

    def __init__(self, cfg: DecoderConfig, params: Mapping[str, Any], *,
                 num_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 decode_width: Optional[int] = None,
                 prefill_buckets=None,
                 prefill_chunk: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 spec_tokens: Optional[int] = None,
                 draft: Optional[str] = None,
                 draft_cfg: Optional[DecoderConfig] = None,
                 draft_params: Optional[Mapping[str, Any]] = None,
                 program_cache_dir: Optional[str] = None,
                 quant_mode: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 kernel: Optional[str] = None,
                 autotune: Optional[bool] = None,
                 device: DeviceLike = None):
        if autotune:
            raise _not_ported("autotune", "A5")
        if program_cache_dir is not None:
            raise _not_ported("the program cache (program_cache_dir)", "A5")
        if kernel is not None:
            raise _not_ported("the kernel= form argument (the device picks "
                              "the kernel)", "A5")
        self.cfg = cfg
        self.device = resolve(device)
        nb = int(num_blocks if num_blocks is not None
                 else get_flag("FLAGS_generation_kv_blocks"))
        bs = int(block_size if block_size is not None
                 else get_flag("FLAGS_generation_block_size"))
        self.decode_width = int(
            decode_width if decode_width is not None
            else get_flag("FLAGS_generation_decode_width"))
        if self.decode_width < 1:
            raise ValueError("decode_width must be >= 1")
        self.spec_tokens = int(spec_tokens if spec_tokens is not None
                               else get_flag("FLAGS_generation_spec_tokens"))
        if self.spec_tokens < 0:
            raise ValueError("spec_tokens must be >= 0")
        self.draft_kind = str(draft if draft is not None
                              else get_flag("FLAGS_generation_draft"))
        self.quant_mode = str(quant_mode if quant_mode is not None
                              else get_flag("FLAGS_quant_mode"))
        if self.quant_mode not in _quant.MODES:
            raise ValueError(f"unknown quant_mode {self.quant_mode!r} "
                             "(off|int8|fp8)")
        if self.quant_mode == "fp8" and not _quant.supports_fp8():
            raise ValueError("quant_mode='fp8' needs torch.float8_e4m3fn "
                             "(quant.supports_fp8()); use 'int8'")
        kvq = str(kv_dtype if kv_dtype is not None
                  else get_flag("FLAGS_generation_kv_quant"))
        if kvq == "auto":
            # follows the weights: a quantized deployment quantizes its
            # pools too; fp8 KV stays opt-in
            kvq = "int8" if self.quant_mode != "off" else "fp32"
        if kvq not in _quant.KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kvq!r} (auto|fp32|int8|fp8)")
        if kvq == "fp8" and not _quant.supports_fp8():
            raise ValueError("kv_dtype='fp8' needs torch.float8_e4m3fn "
                             "(quant.supports_fp8()); use 'int8'")
        self.kv_dtype = kvq
        if self.quant_mode != "off" and not _quant.is_quantized(params):
            # fp32 parameters are converted here; a checkpoint converted
            # before (quant.convert, load_quantized) passes through
            params = _quant.quantize_decoder_params(params, self.quant_mode)
        from ..jit import load_reference_params
        self.params = load_reference_params(cfg, params, self.device)
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else get_flag("FLAGS_generation_prefill_chunk"))
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if self.spec_tokens and not self.prefill_chunk:
            raise ValueError(
                "speculative decoding rides the chunked mixed step: "
                "FLAGS_generation_spec_tokens needs "
                "FLAGS_generation_prefill_chunk > 0")
        if self.kv_dtype != "fp32" and not self.prefill_chunk:
            raise ValueError(
                "quantized KV rides the chunked mixed step: "
                "FLAGS_generation_kv_quant needs "
                "FLAGS_generation_prefill_chunk > 0")
        w = self.decode_width
        if self.prefill_chunk:
            # prompts stream through the mixed step: the ladder is one rung
            self.prefill_ladder = [cfg.max_seq_len]
            tb = int(token_budget if token_budget is not None
                     else get_flag("FLAGS_generation_token_budget"))
            # the auto budget leaves every lane room for its k drafts
            self.token_budget = tb if tb > 0 else \
                w * (1 + self.spec_tokens) + self.prefill_chunk
            if self.token_budget < w:
                raise ValueError(
                    f"token_budget {self.token_budget} < decode_width {w}: "
                    "every decode lane needs a slot each step")
            # sampler rows: 1 + k a lane (its decode slot and its verify
            # slots), so the sampler never sorts prompt or padding slots
            self.sample_width = w * (1 + self.spec_tokens)
        else:
            self.token_budget = self.sample_width = w
            spec = prefill_buckets if prefill_buckets is not None else \
                get_flag("FLAGS_generation_prefill_buckets")
            self.prefill_ladder = [b for b in parse_bucket_ladder(spec)
                                   if b <= cfg.max_seq_len] or \
                [cfg.max_seq_len]
        self.kv = KVCacheManager(nb, bs)
        self.max_blocks_per_seq = self.kv.blocks_for_tokens(cfg.max_seq_len)
        # one attention lane count for prefill and decode: forward_full
        # pads its keys to the pool table's span
        self.attn_lanes = self.max_blocks_per_seq * bs
        shape = (cfg.layers, nb, bs, cfg.heads, cfg.head_dim)
        dev = self.device
        if self.kv_dtype == "fp32":
            self.k_pools = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.v_pools = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.k_scales = self.v_scales = None
        else:
            dt = _quant.storage_dtype(self.kv_dtype)
            self.k_pools = torch.zeros(shape, dtype=dt, device=dev)
            self.v_pools = torch.zeros(shape, dtype=dt, device=dev)
            sshape = shape[:-1]
            self.k_scales = torch.ones(sshape, dtype=torch.float32,
                                       device=dev)
            self.v_scales = torch.ones(sshape, dtype=torch.float32,
                                       device=dev)
        pc_on = bool(prefix_cache if prefix_cache is not None
                     else get_flag("FLAGS_generation_prefix_cache"))
        # chunked mode only: the chunk is the hash unit
        self.prefix_cache = (PrefixCache(self.kv, self.prefill_chunk)
                             if pc_on and self.prefill_chunk else None)
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self.dk_pools = self.dv_pools = None
        # the last exception a drafter raised (its step ran plain decode)
        self.last_draft_fault: Optional[BaseException] = None
        if self.spec_tokens and self.draft_kind == "model":
            if draft_cfg is None or draft_params is None:
                raise ValueError(
                    "draft='model' needs draft_cfg and draft_params")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab {draft_cfg.vocab_size} != "
                                 f"target vocab {cfg.vocab_size}")
            if draft_cfg.max_seq_len < cfg.max_seq_len:
                raise ValueError(
                    f"draft max_seq_len {draft_cfg.max_seq_len} < target "
                    f"{cfg.max_seq_len} (pos_emb must cover every verified "
                    "position)")
            self.draft_params = load_reference_params(draft_cfg,
                                                      draft_params, dev)
            # the drafter's own fp32 pools under the target's block tables
            dshape = (draft_cfg.layers, nb, bs, draft_cfg.heads,
                      draft_cfg.head_dim)
            self.dk_pools = torch.zeros(dshape, dtype=torch.float32,
                                        device=dev)
            self.dv_pools = torch.zeros(dshape, dtype=torch.float32,
                                        device=dev)
        elif self.spec_tokens and self.draft_kind != "ngram":
            raise ValueError(f"unknown draft kind {self.draft_kind!r} "
                             "(ngram|model)")
        self._lane_seq: List[Optional[_Seq]] = [None] * w
        self._tables = np.zeros((w, self.max_blocks_per_seq), np.int32)
        self._ctx = np.zeros((w,), np.int32)
        self._temps = np.zeros((w,), np.float32)
        self._top_ks = np.zeros((w,), np.int32)
        self._top_ps = np.ones((w,), np.float32)
        self._seeds = np.zeros((w,), np.int64)
        self._pending: List[_Seq] = []
        self._admit_counter = 0
        # per-request error sink: the pool points this at the request's
        # future; the bare engine re-raises
        self.on_request_error = None
        self._warmed = False
        self._publish_quant_gauges()

    # --- pool geometry and the quant gauges ------------------------------

    def kv_pool_bytes(self) -> int:
        """Device bytes of the K/V pools, scale pools included."""
        pools = [self.k_pools, self.v_pools]
        if self.k_scales is not None:
            pools += [self.k_scales, self.v_scales]
        return int(sum(p.numel() * p.element_size() for p in pools))

    def kv_bytes_per_seq(self) -> int:
        """Pool bytes of one max-length sequence (payload and scales over
        its table span)."""
        cfg = self.cfg
        per_tok = 2 * cfg.layers * cfg.heads * cfg.head_dim \
            * self.k_pools.element_size()
        if self.k_scales is not None:
            per_tok += 2 * cfg.layers * cfg.heads * 4
        return int(per_tok * self.kv.block_size * self.max_blocks_per_seq)

    def kv_capacity_seqs(self) -> int:
        """Concurrent max-length sequences the pool holds (block 0 is the
        trash block)."""
        return (self.kv.num_blocks - 1) // self.max_blocks_per_seq

    def _publish_quant_gauges(self) -> None:
        """(Re)publish the quant gauges: at construction and after the
        pool's restart, so a rebuilt engine retracts stale values."""
        gauge_set("GAUGE_kv_bytes_per_seq", self.kv_bytes_per_seq())
        gauge_set("GAUGE_kv_capacity_seqs", self.kv_capacity_seqs())
        gauge_set("GAUGE_quant_weight_bytes_saved",
                  _quant.weight_bytes_saved(self.params))

    # --- warmup ------------------------------------------------------------

    def warmup(self, buckets=None) -> dict:
        """Run every step kind once over the trash block, so the kernels are
        built and loaded before the first request: the mixed step (and the
        drafter's step) in chunked mode; the decode step and every prefill
        bucket of the ladder (or of ``buckets``) in two-phase mode.
        Returns the seconds of each."""
        report = {}
        if self.prefill_chunk:
            t0 = time.perf_counter()
            t, sw = self.token_budget, self.sample_width
            zt = np.zeros((t,), np.int32)
            zs = np.zeros((sw,), np.int32)
            self._run_mixed(np.zeros((t, self.max_blocks_per_seq), np.int32),
                            zt, zt, zs, np.zeros((sw,), np.float32), zs,
                            np.ones((sw,), np.float32), zs, zs)
            report["mixed"] = round(time.perf_counter() - t0, 4)
            if self.draft_params is not None:
                t0 = time.perf_counter()
                self._run_draft(np.zeros((t, self.max_blocks_per_seq),
                                         np.int32), zt, zt)
                report["draft"] = round(time.perf_counter() - t0, 4)
        else:
            t0 = time.perf_counter()
            w = self.decode_width
            zw = np.zeros((w,), np.int32)
            self._run_decode(np.zeros((w, self.max_blocks_per_seq), np.int32),
                             zw, zw, np.zeros((w,), np.float32), zw,
                             np.ones((w,), np.float32), zw, zw)
            report["decode"] = round(time.perf_counter() - t0, 4)
            for b in sorted(set(buckets) if buckets is not None
                            else self.prefill_ladder):
                t0 = time.perf_counter()
                _, kc, vc = self._run_prefill(np.zeros((1, int(b)), np.int64),
                                              1)
                self._write_prefill(kc, vc, [TRASH_BLOCK], int(b))
                report[int(b)] = round(time.perf_counter() - t0, 4)
        self._warmed = True
        return report

    # --- admission -------------------------------------------------------

    def submit(self, req: GenerationRequest) -> None:
        """Validate and queue a request. Raises ValueError on one that can
        never run, touching no shared state."""
        prompt = [int(t) for t in req.prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt) + int(req.max_new_tokens)
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")
        if any(t < 0 or t >= self.cfg.vocab_size for t in prompt):
            raise ValueError(f"prompt token outside the vocabulary of "
                             f"{self.cfg.vocab_size}")
        if bucket_for(len(prompt), self.prefill_ladder) is None:
            raise ValueError(f"prompt length {len(prompt)} overflows the "
                             f"prefill ladder {self.prefill_ladder}")
        if self.kv.blocks_for_tokens(total) > self.kv.num_blocks - 1:
            raise ValueError(
                f"request needs {self.kv.blocks_for_tokens(total)} blocks "
                f"but the pool only has {self.kv.num_blocks - 1} "
                "(FLAGS_generation_kv_blocks): it could never run")
        tr = req.trace if req.trace is not None else _tr.begin("generation")
        req = replace(req, prompt=prompt, trace=tr)
        tr.stage("admit")
        self._pending.append(_Seq(req, self._admit_counter))
        self._admit_counter += 1
        stat_add("STAT_generation_requests")

    @property
    def active_count(self) -> int:
        return sum(s is not None for s in self._lane_seq)

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def idle(self) -> bool:
        return self.active_count == 0 and not self._pending

    def step(self) -> List[GenerationResult]:
        """One tick: admit pending requests into free lanes (two-phase
        mode prefills them here), run one mixed or decode step, retire
        finished sequences. Returns the finished results."""
        self._admit()
        if self.active_count == 0:
            return []
        if self.prefill_chunk:
            return self._mixed_once()
        return self._decode_once()

    def _admit(self) -> None:
        """Admit pending requests into free lanes, oldest first (a
        preempted request is re-queued at the front). A full pool stops
        admission. A never-started request whose admission raises is
        failed alone; a replayed one is retried up to
        _REPLAY_ADMIT_RETRIES times first."""
        for lane in range(self.decode_width):
            if not self._pending or self._lane_seq[lane] is not None:
                continue
            seq = self._pending[0]
            try:
                ok = self._admit_chunked(seq, lane) if self.prefill_chunk \
                    else self._prefill_into(seq, lane)
                if not ok:
                    break                      # pool full: try later
            except Exception as e:  # noqa: BLE001 - per-request isolation
                if seq.evictions and \
                        seq.admit_failures < _REPLAY_ADMIT_RETRIES:
                    seq.admit_failures += 1
                    stat_add("STAT_generation_replay_retries")
                    break
                self._pending.pop(0)
                stat_add("STAT_generation_errors")
                seq.req.trace.finish(error=e)
                self._deliver_error(seq, e)
                continue
            self._pending.pop(0)
        gauge_set("GAUGE_generation_active_seqs", self.active_count)

    def _park(self, seq: _Seq, lane: int, table, ctx: int) -> None:
        """Put ``seq`` in ``lane``: its table, length and sampling."""
        seq.lane = lane
        self._lane_seq[lane] = seq
        sp = seq.req.sampling
        self._tables[lane] = table
        self._ctx[lane] = ctx
        self._temps[lane] = sp.temperature
        self._top_ks[lane] = sp.top_k
        self._top_ps[lane] = sp.top_p
        self._seeds[lane] = sp.seed

    def _admit_chunked(self, seq: _Seq, lane: int) -> bool:
        """Park ``seq`` in ``lane``: attach the longest cached prefix and
        private blocks for the rest of the prompt plus the first token,
        all or nothing. A hit re-runs at least the last prompt token (its
        logits give the first token). Returns False, with nothing changed,
        when the pool cannot hold it yet."""
        n = len(seq.req.prompt)
        pc = self.prefix_cache
        t0 = time.perf_counter()
        cached_use = 0
        shared: List[int] = []
        if pc is not None:
            if seq.pkeys is None:
                seq.pkeys = pc.keys_for(seq.req.prompt)
            hit = pc.match(seq.req.prompt)
            if hit is not None:
                cached_tokens, blocks = hit
                cached_use = min(int(cached_tokens), n - 1)
                shared = blocks[:self.kv.blocks_for_tokens(cached_use)]
        private_need = self.kv.blocks_for_tokens(n + 1) - len(shared)
        if private_need > self.kv.free_blocks:
            if pc is None or not pc.evict_for(private_need):
                return False
        tr = seq.req.trace
        tr.stage("prefill_start")
        if seq.evictions:
            tr.event("replay", evictions=seq.evictions)
        sid = id(seq)
        self.kv.attach(sid, shared, private_need)
        seq.prefilled = cached_use
        seq.ctx = cached_use
        seq.published = cached_use
        self._park(seq, lane, self.kv.table(sid, self.max_blocks_per_seq),
                   cached_use)
        if pc is not None:
            if cached_use:
                stat_add("STAT_generation_prefix_hits")
                stat_add("STAT_generation_prefix_hit_tokens", cached_use)
                tr.event("prefix_hit_chunks", tokens=cached_use,
                         chunks=cached_use // self.prefill_chunk,
                         blocks=len(shared))
            else:
                stat_add("STAT_generation_prefix_misses")
            timer_observe("TIMER_generation_prefix_admit_us",
                          (time.perf_counter() - t0) * 1e6)
        stat_add("STAT_generation_prefills")
        return True

    # --- two-phase mode --------------------------------------------------

    def _run_prefill(self, tokens: np.ndarray, n: int):
        """forward_full over one padded prompt at the engine's attention
        lanes: (logits [1, V], k_cache, v_cache [layers, 1, bucket, H,
        D])."""
        dev = self.device
        return forward_full(self.cfg, self.params,
                            torch.from_numpy(tokens).to(dev),
                            torch.tensor([n], device=dev),
                            attn_lanes=self.attn_lanes)

    def _write_prefill(self, kc: torch.Tensor, vc: torch.Tensor, table,
                       bucket: int) -> None:
        """Write a prefill's K/V rows into the pools in place over the whole
        bucket: position p at (table[p // bs], p % bs). Padding positions
        land in the trash block or in the sequence's own blocks ahead of
        its length, which the decode steps overwrite before any mask shows
        them."""
        bs = self.kv.block_size
        pos = np.arange(bucket)
        tbl = np.asarray(table, np.int64)
        blk = torch.from_numpy(tbl[np.minimum(pos // bs, len(tbl) - 1)])
        off = torch.from_numpy((pos % bs).astype(np.int64))
        idx = (slice(None), blk.to(self.device), off.to(self.device))
        self.k_pools[idx] = kc[:, 0]
        self.v_pools[idx] = vc[:, 0]

    def _prefill_into(self, seq: _Seq, lane: int) -> bool:
        """Two-phase admission: the whole prompt through forward_full at a
        bucket of the ladder, its K/V written into the pool, its first
        token sampled at step 0, then ``seq`` parked in ``lane``. Returns
        False, with nothing changed, when the pool cannot hold the
        prompt."""
        prompt = seq.req.prompt
        n = len(prompt)
        need = self.kv.blocks_for_tokens(n + 1)     # room for the 1st decode
        if need > self.kv.free_blocks:
            return False
        tr = seq.req.trace
        tr.stage("prefill_start")
        if seq.evictions:
            tr.event("replay", evictions=seq.evictions)
        # the bucket pads bucket - n token slots: the waste the chunked
        # mode removes
        bucket = bucket_for(n, self.prefill_ladder)
        if bucket > n:
            stat_add("STAT_generation_pad_tokens", bucket - n)
        t0 = time.perf_counter()
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = prompt
        logits, kc, vc = self._run_prefill(toks, n)
        sid = id(seq)
        self.kv.alloc(sid, need)
        table = self.kv.table(sid, self.max_blocks_per_seq)
        self._write_prefill(kc, vc, table, bucket)
        first = int(self._sample_host(seq, logits, step=0))
        timer_observe("TIMER_generation_prefill_us",
                      (time.perf_counter() - t0) * 1e6)
        stat_add("STAT_generation_prefills")
        tr.token()
        seq.generated.append(first)
        seq.ctx = n
        seq.prefilled = n
        seq.t_last_token = time.perf_counter()
        self._park(seq, lane, table, n)
        stat_add("STAT_generation_tokens")
        return True

    def _sample_host(self, seq: _Seq, logits: torch.Tensor, step: int) -> int:
        """One token outside the decode batch (a prefill's first token),
        through the batch's sampler, so the stream equals a batched run."""
        sp = seq.req.sampling
        return int(sample_tokens(logits, [sp.temperature], [sp.top_k],
                                 [sp.top_p], [sp.seed], [step])[0])

    def _run_decode(self, tables, ctx, tokens, temps, top_ks, top_ps, seeds,
                    steps) -> np.ndarray:
        """One token a lane through forward_paged (writing the pools in
        place), then the sampler; the tokens come back to the host."""
        dev = self.device
        logits = forward_paged(
            self.cfg, self.params, self.k_pools, self.v_pools,
            torch.from_numpy(tables).to(dev), torch.from_numpy(ctx).to(dev),
            torch.from_numpy(tokens).to(dev))
        return sample_tokens(logits, temps, top_ks, top_ps, seeds,
                             steps).cpu().numpy()

    def _decode_once(self) -> List[GenerationResult]:
        """Two-phase step: every active lane one token (idle lanes spin on
        the trash block)."""
        finished: List[GenerationResult] = []
        # retire sequences whose previous token already ended them
        for lane, seq in enumerate(self._lane_seq):
            if seq is not None:
                done = self._finish_reason(seq)
                if done is not None:
                    finished.append(self._retire(lane, done))
        self._ensure_blocks()
        w = self.decode_width
        active = [ln for ln, s in enumerate(self._lane_seq) if s is not None]
        if not active:
            gauge_set("GAUGE_generation_active_seqs", 0)
            return finished
        # idle lanes ride the fixed-width batch as padding
        stat_add("STAT_generation_pad_tokens", w - len(active))
        tokens = np.zeros((w,), np.int32)
        steps = np.zeros((w,), np.int64)
        for ln in active:
            seq = self._lane_seq[ln]
            tokens[ln] = seq.generated[-1]
            steps[ln] = len(seq.generated)
        t0 = time.perf_counter()
        nxt = self._run_decode(self._tables, self._ctx, tokens, self._temps,
                               self._top_ks, self._top_ps, self._seeds, steps)
        timer_observe("TIMER_generation_decode_step_us",
                      (time.perf_counter() - t0) * 1e6)
        now = time.perf_counter()
        for ln in active:
            seq = self._lane_seq[ln]
            seq.ctx += 1
            self._ctx[ln] = seq.ctx
            self._emit(seq, int(nxt[ln]), now)
            done = self._finish_reason(seq)
            if done is not None:
                finished.append(self._retire(ln, done))
        gauge_set("GAUGE_generation_active_seqs", self.active_count)
        return finished

    def _ensure_blocks(self) -> None:
        """Before a decode step, give every lane whose next write crosses
        into an unowned block one more block; an empty pool preempts the
        youngest sequence until the rest fit."""
        while True:
            try:
                for lane, seq in enumerate(self._lane_seq):
                    if seq is None:
                        continue
                    sid = id(seq)
                    need = self.kv.blocks_for_tokens(seq.ctx + 1)
                    while len(self.kv.owned(sid)) < need:
                        self.kv.extend(sid)
                        self._tables[lane] = self.kv.table(
                            sid, self.max_blocks_per_seq)
                return
            except BlockPoolExhausted:
                if not self._preempt_youngest():
                    raise

    # --- the mixed step --------------------------------------------------

    def _run_mixed(self, tables, positions, tokens, sample_slots, temps,
                   top_ks, top_ps, seeds, steps) -> np.ndarray:
        """forward_paged over the slots (writing the pools in place), then
        the sampler over the sample rows; the tokens come back to the
        host."""
        dev = self.device
        logits = forward_paged(
            self.cfg, self.params, self.k_pools, self.v_pools,
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(tokens).to(dev),
            k_scale_pools=self.k_scales, v_scale_pools=self.v_scales)
        rows = logits[torch.from_numpy(sample_slots).long().to(dev)]
        nxt = sample_tokens(rows, temps, top_ks, top_ps, seeds, steps)
        return nxt.cpu().numpy()

    def _run_draft(self, tables, positions, tokens) -> np.ndarray:
        """The drafter's step over the same slot layout into its own pools;
        greedy (drafts only decide acceptance, never a token's value)."""
        dev = self.device
        logits = forward_paged(
            self.draft_cfg, self.draft_params, self.dk_pools, self.dv_pools,
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(tokens).to(dev))
        return logits.argmax(dim=-1).cpu().numpy()

    def _mixed_once(self) -> List[GenerationResult]:
        """One mixed step: every decoding lane's next token and its verify
        slots, then up to prefill_chunk prompt tokens per prefilling lane,
        in token_budget slots; the rest spin on the trash block."""
        finished: List[GenerationResult] = []
        # retire sequences whose previous token already ended them
        for lane, seq in enumerate(self._lane_seq):
            if seq is not None:
                done = self._finish_reason(seq)
                if done is not None:
                    finished.append(self._retire(lane, done))
        t = self.token_budget
        m = self.max_blocks_per_seq
        # each decode lane's draft budget this step (none without spec)
        s_cap = self._spec_caps()
        # provision every lane's writes (block extension, copy-on-write);
        # under pool pressure evict cold prefixes, then preempt. Re-running
        # _provision after either is idempotent.
        while True:
            try:
                self._provision(s_cap)
                break
            except BlockPoolExhausted:
                if self.prefix_cache is not None and \
                        self.prefix_cache.evict_for(1):
                    continue
                if not self._preempt_youngest():
                    raise
        decode_lanes, prefill_lanes = [], []
        for ln, s in enumerate(self._lane_seq):
            if s is None:
                continue
            if s.prefilled >= len(s.req.prompt):
                decode_lanes.append(ln)
            else:
                prefill_lanes.append(ln)
        if not decode_lanes and not prefill_lanes:
            gauge_set("GAUGE_generation_active_seqs", 0)
            return finished
        # the chunk plan comes before drafting, on the slots s_cap allows:
        # the model drafter's first call ingests these chunks into its
        # pools; slots a shorter proposal leaves free pad
        slot = len(decode_lanes) + sum(s_cap.get(ln, 0) for ln in decode_lanes)
        chunk_plan = []              # (lane, seq, start, take)
        for ln in prefill_lanes:
            seq = self._lane_seq[ln]
            n = len(seq.req.prompt)
            take = min(self.prefill_chunk, n - seq.prefilled, t - slot)
            if take <= 0:
                continue
            chunk_plan.append((ln, seq, seq.prefilled, take))
            slot += take
        drafts = self._propose(decode_lanes, s_cap, chunk_plan)
        tables = np.full((t, m), TRASH_BLOCK, np.int32)
        positions = np.zeros((t,), np.int32)
        tokens = np.zeros((t,), np.int32)
        # sampler rows: 1 + k a lane, rows ln*(1+k) .. ln*(1+k)+k; a decode
        # lane's verify chain uses rows 0..len(drafts), a prefilling lane
        # row 0 for its chunk's last slot; unused rows read slot 0 greedily
        # and are discarded
        sw = self.sample_width
        rpl = 1 + self.spec_tokens
        sample_slots = np.zeros((sw,), np.int32)
        temps = np.zeros((sw,), np.float32)
        tks = np.zeros((sw,), np.int32)
        tps = np.ones((sw,), np.float32)
        seeds = np.zeros((sw,), np.int64)
        steps = np.zeros((sw,), np.int64)
        slot = 0
        decode_plan = []            # (lane, seq, first row, drafts)
        for ln in decode_lanes:
            seq = self._lane_seq[ln]
            d = drafts.get(ln, [])[:s_cap.get(ln, 0)]
            feed = [seq.generated[-1]] + d
            base = len(seq.generated)
            row0 = ln * rpl
            for j, tok in enumerate(feed):
                r = row0 + j
                tables[slot] = self._tables[ln]
                positions[slot] = seq.ctx + j
                tokens[slot] = tok
                sample_slots[r] = slot
                temps[r] = self._temps[ln]
                tks[r] = self._top_ks[ln]
                tps[r] = self._top_ps[ln]
                seeds[r] = self._seeds[ln]
                # the step is the token's index in its sequence: row j
                # samples what plain decode would at that index
                steps[r] = base + j
                slot += 1
            decode_plan.append((ln, seq, row0, d))
        for ln, seq, start, take in chunk_plan:
            sp = seq.req.sampling
            for j in range(take):
                tables[slot] = self._tables[ln]
                positions[slot] = start + j
                tokens[slot] = seq.req.prompt[start + j]
                slot += 1
            # only the last slot's sample counts, and only when the chunk
            # completes the prompt (step 0, the first generated token)
            row0 = ln * rpl
            sample_slots[row0] = slot - 1
            temps[row0] = sp.temperature
            tks[row0] = sp.top_k
            tps[row0] = sp.top_p
            seeds[row0] = sp.seed
            steps[row0] = 0
        stat_add("STAT_generation_pad_tokens", t - slot)
        if self.k_scales is not None:
            bs_q = self.kv.block_size
            written = {int(tables[i][positions[i] // bs_q])
                       for i in range(slot)}
            written.discard(TRASH_BLOCK)
            stat_add("STAT_generation_kv_quant_blocks", len(written))
        t0 = time.perf_counter()
        nxt = self._run_mixed(tables, positions, tokens, sample_slots, temps,
                              tks, tps, seeds, steps)
        dt_us = (time.perf_counter() - t0) * 1e6
        timer_observe("TIMER_generation_mixed_step_us", dt_us)
        # the mixed step is this engine's decode step too
        timer_observe("TIMER_generation_decode_step_us", dt_us)
        now = time.perf_counter()
        for ln, seq, row0, d in decode_plan:
            s = len(d)
            if s:
                stat_add("STAT_generation_spec_proposed", s)
            acc = 0
            # row j is valid iff every draft before it matched: emit up to
            # the first mismatch
            for j in range(s + 1):
                tok = int(nxt[row0 + j])
                seq.ctx += 1
                self._ctx[ln] = seq.ctx
                self._emit(seq, tok, now)
                done = self._finish_reason(seq)
                if done is not None:
                    finished.append(self._retire(ln, done))
                    break
                if j < s:
                    if d[j] != tok:
                        break
                    acc += 1
            if s:
                stat_add("STAT_generation_spec_accepted", acc)
        for ln, seq, start, take in chunk_plan:
            seq.prefilled = start + take
            seq.ctx = seq.prefilled
            self._ctx[ln] = seq.ctx
            seq.req.trace.event("prefill_chunk", start=start, width=take)
            self._publish_prefix(seq)
            if seq.prefilled == len(seq.req.prompt):
                seq.generated.append(int(nxt[ln * rpl]))
                seq.req.trace.token()
                seq.t_last_token = now
                stat_add("STAT_generation_tokens")
                done = self._finish_reason(seq)
                if done is not None:
                    finished.append(self._retire(ln, done))
        gauge_set("GAUGE_generation_active_seqs", self.active_count)
        return finished

    def _emit(self, seq: _Seq, tok: int, now: float) -> None:
        """A decoded token: appended, traced, timed and counted."""
        seq.generated.append(tok)
        seq.req.trace.token()
        timer_observe("TIMER_generation_inter_token_us",
                      (now - seq.t_last_token) * 1e6)
        seq.t_last_token = now
        stat_add("STAT_generation_tokens")

    def _spec_caps(self) -> Dict[int, int]:
        """How many drafts each decode lane may verify this step: at most
        k, the request's remaining tokens less the one plain decode gives,
        the position table's room and the slot budget (each decode lane
        keeps its own slot; extras go greedily in lane order)."""
        k = self.spec_tokens
        if not k:
            return {}
        decode = [ln for ln, s in enumerate(self._lane_seq)
                  if s is not None and s.prefilled >= len(s.req.prompt)]
        budget = self.token_budget - len(decode)
        caps: Dict[int, int] = {}
        for ln in decode:
            seq = self._lane_seq[ln]
            s = max(0, int(min(k,
                               seq.req.max_new_tokens - len(seq.generated) - 1,
                               self.cfg.max_seq_len - 1 - seq.ctx, budget)))
            caps[ln] = s
            budget -= s
        return caps

    def _provision(self, s_cap: Dict[int, int]) -> None:
        """Make every lane's writes of this step safe: extend a decoding
        lane's table to ctx + its drafts, and copy-on-write every
        still-shared block the step writes into. Raises
        BlockPoolExhausted; the caller evicts or preempts and re-runs
        this."""
        bs = self.kv.block_size
        for lane, seq in enumerate(self._lane_seq):
            if seq is None:
                continue
            sid = id(seq)
            n = len(seq.req.prompt)
            if seq.prefilled >= n:
                lo, hi = seq.ctx, seq.ctx + s_cap.get(lane, 0)
                need = self.kv.blocks_for_tokens(hi + 1)
            else:
                # the prompt and first token were allocated at admission
                lo = seq.prefilled
                hi = min(seq.prefilled + self.prefill_chunk, n) - 1
                need = 0
            while len(self.kv.owned(sid)) < need:
                self.kv.extend(sid)
            owned = self.kv.owned(sid)
            for bi in range(lo // bs, hi // bs + 1):
                if bi < len(owned) and self.kv.refcount(owned[bi]) > 1:
                    old, new = self.kv.cow(sid, bi)
                    self._copy_block(old, new)
                    stat_add("STAT_generation_prefix_cow_copies")
            self._tables[lane] = self.kv.table(sid, self.max_blocks_per_seq)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one pool block's rows, every layer, src -> dst, in place
        (the device half of copy-on-write); the drafter's pools too."""
        pools = [self.k_pools, self.v_pools]
        if self.k_scales is not None:
            pools += [self.k_scales, self.v_scales]
        if self.dk_pools is not None:
            pools += [self.dk_pools, self.dv_pools]
        for p in pools:
            p[:, dst] = p[:, src]

    def _propose(self, decode_lanes: List[int], s_cap: Dict[int, int],
                 chunk_plan) -> Dict[int, List[int]]:
        """Up to s_cap[lane] drafts a decode lane. A drafter that raises
        degrades this step to plain decode (drafts decide how many slots
        verify, never which tokens are emitted, so the streams stay the
        same) and counts in STAT_generation_draft_faults."""
        if not self.spec_tokens:
            return {}
        lanes = [ln for ln in decode_lanes if s_cap.get(ln, 0) > 0]
        # the model drafter ingests prompt chunks on prefill-only steps
        # too; the ngram drafter has no state
        if not lanes and self.draft_params is None:
            return {}
        try:
            if self.draft_params is not None:
                return self._propose_model(lanes, s_cap, chunk_plan)
            out: Dict[int, List[int]] = {}
            for ln in lanes:
                seq = self._lane_seq[ln]
                d = _ngram_propose(list(seq.req.prompt) + seq.generated,
                                   s_cap[ln])
                if d:
                    out[ln] = d
            return out
        except Exception as e:  # noqa: BLE001 - degrades to plain decode
            self.last_draft_fault = e
            stat_add("STAT_generation_draft_faults")
            return {}

    def _propose_model(self, lanes: List[int], s_cap: Dict[int, int],
                       chunk_plan) -> Dict[int, List[int]]:
        """Greedy drafts from the draft model: max_s + 1 calls of its step.
        Call j feeds each lane's token at position ctx + j (call 0 the last
        emitted token, later calls the previous call's argmax); the extra
        last call writes the last draft's K/V, so full acceptance leaves no
        gap in the draft pools. Call 0 also ingests this step's prompt
        chunks, so the draft pools follow the target's context (a prefix
        cache hit leaves them cold over the cached part: fewer
        acceptances, the same tokens)."""
        t, m = self.token_budget, self.max_blocks_per_seq
        max_s = max((s_cap[ln] for ln in lanes), default=0)
        feeds = {ln: self._lane_seq[ln].generated[-1] for ln in lanes}
        out: Dict[int, List[int]] = {ln: [] for ln in lanes}
        for j in range(max_s + 1):
            tables = np.full((t, m), TRASH_BLOCK, np.int32)
            positions = np.zeros((t,), np.int32)
            tokens = np.zeros((t,), np.int32)
            slot = 0
            slot_of = {}
            for ln in lanes:
                if j > s_cap[ln]:
                    continue
                seq = self._lane_seq[ln]
                tables[slot] = self._tables[ln]
                positions[slot] = seq.ctx + j
                tokens[slot] = feeds[ln]
                slot_of[ln] = slot
                slot += 1
            if j == 0:
                for ln, seq, start, take in chunk_plan:
                    for i in range(min(take, t - slot)):
                        tables[slot] = self._tables[ln]
                        positions[slot] = start + i
                        tokens[slot] = seq.req.prompt[start + i]
                        slot += 1
            nxt = self._run_draft(tables, positions, tokens)
            for ln, sl in slot_of.items():
                if j < s_cap[ln]:
                    tok = int(nxt[sl])
                    out[ln].append(tok)
                    feeds[ln] = tok
        return {ln: d for ln, d in out.items() if d}

    def _publish_prefix(self, seq: _Seq) -> None:
        """Offer each newly completed chunk boundary of the prompt to the
        prefix cache; the producer's next write into a published partial
        block copies it first."""
        pc = self.prefix_cache
        if pc is None or seq.pkeys is None:
            return
        sid = id(seq)
        for tokens_b, key in seq.pkeys:
            if tokens_b <= seq.published:
                continue
            if tokens_b > seq.prefilled:
                break
            blocks = self.kv.owned(sid)[:self.kv.blocks_for_tokens(tokens_b)]
            pc.insert(key, tokens_b, blocks)
            seq.published = tokens_b

    def _finish_reason(self, seq: _Seq) -> Optional[str]:
        eos = seq.req.eos_token
        if eos is not None and seq.generated and seq.generated[-1] == eos:
            return "eos"
        if len(seq.generated) >= seq.req.max_new_tokens:
            return "length"
        return None

    def _retire(self, lane: int, reason: str) -> GenerationResult:
        seq = self._lane_seq[lane]
        self._lane_seq[lane] = None
        self.kv.free(id(seq))
        self._tables[lane] = TRASH_BLOCK
        self._ctx[lane] = 0
        toks = list(seq.generated)
        if reason == "eos":
            toks = toks[:-1]
        seq.req.trace.finish(finish_reason=reason, tokens=len(toks),
                             evictions=seq.evictions)
        return GenerationResult(request_id=seq.req.request_id,
                                prompt_len=len(seq.req.prompt), tokens=toks,
                                finish_reason=reason,
                                evictions=seq.evictions)

    def _preempt_youngest(self) -> bool:
        """Evict the most recently admitted active sequence: free its
        private blocks and re-queue it at the front of pending."""
        cand = None
        for seq in self._lane_seq:
            if seq is not None and (cand is None or
                                    seq.admit_order > cand.admit_order):
                cand = seq
        if cand is None:
            return False
        lane = cand.lane
        self._lane_seq[lane] = None
        self.kv.evict(id(cand))
        self._tables[lane] = TRASH_BLOCK
        self._ctx[lane] = 0
        cand.req.trace.event("preempt", lane=lane, ctx=int(cand.ctx),
                             generated=len(cand.generated))
        fresh = _Seq(cand.req, cand.admit_order)
        fresh.evictions = cand.evictions + 1
        self._pending.insert(0, fresh)
        return True

    def _deliver_error(self, seq: _Seq, exc: Exception) -> None:
        """A per-request failure goes to the pool's future when one is
        set, else it is raised."""
        if self.on_request_error is not None:
            self.on_request_error(seq.req, exc)
        else:
            raise exc

    def generate(self, reqs: Sequence[GenerationRequest],
                 max_steps: Optional[int] = None) -> List[GenerationResult]:
        """Run a batch of requests to completion; results come back in
        completion order (match them by request_id). Raises RuntimeError
        past ``max_steps`` steps."""
        for i, r in enumerate(reqs):
            if r.request_id is None:
                r = replace(r, request_id=i)
            self.submit(r)
        out: List[GenerationResult] = []
        steps = 0
        # chunked mode spends up to ceil(prompt / chunk) more steps a
        # request streaming the prompt in
        per_req = (2 if self.prefill_chunk else 1) * self.cfg.max_seq_len + 4
        limit = max_steps if max_steps is not None else \
            per_req * max(1, len(reqs))
        while not self.idle and steps < limit:
            out.extend(self.step())
            steps += 1
        if not self.idle:
            raise RuntimeError(f"generation did not converge in {limit} "
                               "steps")
        return out


def _ngram_propose(hist: List[int], k: int) -> List[int]:
    """Prompt-lookup drafting: the k tokens that followed the most recent
    earlier occurrence of the history's last m tokens (m = 3, 2, 1) in
    the request's own prompt and output. A wrong guess costs a verify
    slot, never a wrong token."""
    n = len(hist)
    for mlen in (3, 2, 1):
        if n <= mlen:
            continue
        suffix = hist[n - mlen:]
        for i in range(n - mlen - 1, -1, -1):
            if hist[i:i + mlen] == suffix:
                out = hist[i + mlen:i + mlen + k]
                if out:
                    return list(out)
                break
    return []


class NaiveGenerator:
    """The oracle: every new token re-runs ``forward_full`` over the whole
    context, padded to a bucket of the ladder
    (``FLAGS_generation_prefill_buckets`` by default), with the engine's
    sampler. Pass the engine's ``attn_lanes`` to attend over the same lane
    count."""

    def __init__(self, cfg: DecoderConfig, params: Mapping[str, Any],
                 buckets=None, attn_lanes: int = 0,
                 device: DeviceLike = None):
        from ..jit import load_reference_params
        self.cfg = cfg
        self.device = resolve(device)
        self.params = load_reference_params(cfg, params, self.device)
        spec = buckets if buckets is not None else \
            get_flag("FLAGS_generation_prefill_buckets")
        self.ladder = [b for b in parse_bucket_ladder(spec)
                       if b <= cfg.max_seq_len] or [cfg.max_seq_len]
        self.attn_lanes = int(attn_lanes)

    def generate(self, req: GenerationRequest) -> GenerationResult:
        toks = [int(t) for t in req.prompt]
        n0 = len(toks)
        sp = req.sampling
        out: List[int] = []
        reason = "length"
        for step in range(req.max_new_tokens):
            n = len(toks)
            bucket = bucket_for(n, self.ladder) or self.cfg.max_seq_len
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = toks
            logits = forward_full(
                self.cfg, self.params,
                torch.from_numpy(padded).to(self.device),
                torch.tensor([n], device=self.device),
                attn_lanes=self.attn_lanes)[0]
            tok = int(sample_tokens(logits, [sp.temperature], [sp.top_k],
                                    [sp.top_p], [sp.seed], [step])[0])
            if req.eos_token is not None and tok == req.eos_token:
                reason = "eos"
                break
            out.append(tok)
            toks.append(tok)
        return GenerationResult(request_id=req.request_id, prompt_len=n0,
                                tokens=out, finish_reason=reason)
