"""GenerationEngine: continuous batching over the paged KV cache, chunked
mixed steps.

Counterpart of ``paddle_tpu/generation/engine.py`` in its default,
chunked mode (``FLAGS_generation_prefill_chunk`` > 0). The engine owns the
device state (the parameters and the per-layer K/V block pools) and
``decode_width`` lanes. Every step runs one mixed forward over a fixed
``token_budget`` of slots: each decoding lane's next token first (decode
never waits for a prefill), then up to ``prefill_chunk`` prompt tokens for
each prefilling lane, in lane order; unused slots spin on the trash block
(``STAT_generation_pad_tokens``). A sequence is admitted with blocks for
its whole prompt and first token, streams its prompt in chunk by chunk
while the other lanes decode, samples its first token from the last
chunk's last slot, decodes one token a step, and leaves at EOS or
max_new_tokens.

- Prefix cache (``FLAGS_generation_prefix_cache``): admission attaches
  the longest cached chunk-aligned prefix read-only and starts prefill at
  the first uncached chunk; completed chunk boundaries are published back.
  A write into a still-shared block copies it first (copy-on-write: the
  ledger swaps in a private block, ``_copy_block`` copies its rows in
  every layer, scale pools included).
- Pool pressure: cold cached prefixes are evicted LRU-first, then the
  youngest sequence is preempted and re-queued at the front; sampling is
  a pure function of (logits, seed, step), so its replay regenerates the
  same tokens.
- KV dtype: fp32 pools, or int8/fp8 pools with per-token-per-head fp32
  scale pools (initialised to one, so a never-written row dequantizes to
  exact 0).

There is no compiled-step registry: eager PyTorch runs each step as it
comes. The engine runs on the card unless the caller asks for
``device="cpu"``; without CUDA the default raises. Not ported yet, and
refused with ``NotImplementedError`` naming the ``ROADMAP.md`` item: the
two-phase mode (``prefill_chunk=0``), speculative decoding
(``spec_tokens``, the ngram and model drafters), weight quantization
(``quant_mode``), ``autotune``, ``program_cache_dir`` and the ``kernel=``
form (on the port the device picks the path). Failpoints are omitted
(A7).

Instruments: STAT_generation_requests / _tokens / _prefills /
_evictions / _errors / _pad_tokens / _replay_retries,
STAT_generation_prefix_{hits,misses,hit_tokens,cow_copies},
STAT_generation_kv_quant_blocks, GAUGE_generation_active_seqs,
GAUGE_kv_bytes_per_seq / _capacity_seqs, TIMER_generation_mixed_step_us
(also as _decode_step_us), _inter_token_us and _prefix_admit_us; each
request carries a ``tracing.RequestTrace``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import tracing as _tr
from ..device import DeviceLike, resolve
from ..flags import get_flag
from ..monitor import gauge_set, stat_add, timer_observe
from ..quant import KV_DTYPES, storage_dtype
from .kv_cache import (TRASH_BLOCK, BlockPoolExhausted, KVCacheManager,
                       PrefixCache)
from .model import DecoderConfig, forward_full, forward_paged
from .sampling import SamplingParams, sample_tokens

__all__ = ["GenerationEngine", "GenerationRequest", "GenerationResult",
           "NaiveGenerator", "bucket_for", "parse_bucket_ladder"]

# consecutive transient re-admission failures a replayed (preempted)
# request survives before it is failed
_REPLAY_ADMIT_RETRIES = 8
# prompt-length ladder of the naive oracle (the reference's default
# FLAGS_generation_prefill_buckets)
_NAIVE_BUCKETS = "pow2:512"


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

    ``submit()`` queues a request, ``step()`` runs one mixed step and
    returns the requests that finished, ``generate()`` runs a batch to
    completion. Not thread-safe: ``GenerationPool`` is the concurrent
    front end."""

    def __init__(self, cfg: DecoderConfig, params: Mapping[str, Any], *,
                 num_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 decode_width: Optional[int] = None,
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
        if spec_tokens or draft is not None or draft_cfg is not None or \
                draft_params is not None:
            raise _not_ported("speculative decoding (spec_tokens, the "
                              "ngram and model drafters)", "A4")
        if quant_mode not in (None, "off"):
            raise _not_ported("weight quantization (quant_mode)", "A4")
        if autotune:
            raise _not_ported("autotune", "A5")
        if program_cache_dir is not None:
            raise _not_ported("the program cache (program_cache_dir)", "A5")
        if kernel is not None:
            raise _not_ported("the kernel= form argument (the device picks "
                              "the kernel)", "A5")
        self.cfg = cfg
        self.device = resolve(device)
        from ..jit import load_reference_params
        self.params = load_reference_params(cfg, params, self.device)
        nb = int(num_blocks if num_blocks is not None
                 else get_flag("FLAGS_generation_kv_blocks"))
        bs = int(block_size if block_size is not None
                 else get_flag("FLAGS_generation_block_size"))
        self.decode_width = int(
            decode_width if decode_width is not None
            else get_flag("FLAGS_generation_decode_width"))
        if self.decode_width < 1:
            raise ValueError("decode_width must be >= 1")
        kvq = str(kv_dtype if kv_dtype is not None
                  else get_flag("FLAGS_generation_kv_quant"))
        if kvq == "auto":
            # follows the weight mode, which is "off" until A4 ports it
            kvq = "fp32"
        if kvq not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kvq!r} (auto|fp32|int8|fp8)")
        self.kv_dtype = kvq
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else get_flag("FLAGS_generation_prefill_chunk"))
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if self.prefill_chunk == 0:
            raise _not_ported("the two-phase mode (prefill_chunk=0: bucketed "
                              "forward_full prefill and a decode step)", "A4")
        tb = int(token_budget if token_budget is not None
                 else get_flag("FLAGS_generation_token_budget"))
        self.token_budget = tb if tb > 0 else \
            self.decode_width + self.prefill_chunk
        if self.token_budget < self.decode_width:
            raise ValueError(
                f"token_budget {self.token_budget} < decode_width "
                f"{self.decode_width}: every decode lane needs a slot each "
                "step")
        self.sample_width = self.decode_width
        self.kv = KVCacheManager(nb, bs)
        self.max_blocks_per_seq = self.kv.blocks_for_tokens(cfg.max_seq_len)
        self.attn_lanes = self.max_blocks_per_seq * bs
        shape = (cfg.layers, nb, bs, cfg.heads, cfg.head_dim)
        dev = self.device
        if self.kv_dtype == "fp32":
            self.k_pools = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.v_pools = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.k_scales = self.v_scales = None
        else:
            dt = storage_dtype(self.kv_dtype)
            self.k_pools = torch.zeros(shape, dtype=dt, device=dev)
            self.v_pools = torch.zeros(shape, dtype=dt, device=dev)
            sshape = shape[:-1]
            self.k_scales = torch.ones(sshape, dtype=torch.float32,
                                       device=dev)
            self.v_scales = torch.ones(sshape, dtype=torch.float32,
                                       device=dev)
        pc_on = bool(prefix_cache if prefix_cache is not None
                     else get_flag("FLAGS_generation_prefix_cache"))
        self.prefix_cache = (PrefixCache(self.kv, self.prefill_chunk)
                             if pc_on else None)
        w = self.decode_width
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
        self._publish_gauges()

    # --- pool geometry ---------------------------------------------------

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

    def _publish_gauges(self) -> None:
        gauge_set("GAUGE_kv_bytes_per_seq", self.kv_bytes_per_seq())
        gauge_set("GAUGE_kv_capacity_seqs", self.kv_capacity_seqs())

    def warmup(self) -> dict:
        """One mixed step over idle slots (trash block only), so the
        kernels are built and loaded before the first request."""
        t0 = time.perf_counter()
        t, sw = self.token_budget, self.sample_width
        zt = np.zeros((t,), np.int32)
        zs = np.zeros((sw,), np.int32)
        self._run_mixed(np.zeros((t, self.max_blocks_per_seq), np.int32),
                        zt, zt, zs, np.zeros((sw,), np.float32), zs,
                        np.ones((sw,), np.float32), zs, zs)
        return {"mixed": round(time.perf_counter() - t0, 4)}

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
        """One tick: admit pending requests into free lanes, run one mixed
        step, retire finished sequences. Returns the finished results."""
        self._admit()
        if self.active_count == 0:
            return []
        return self._mixed_once()

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
                if not self._admit_chunked(seq, lane):
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
        seq.lane = lane
        seq.prefilled = cached_use
        seq.ctx = cached_use
        seq.published = cached_use
        self._lane_seq[lane] = seq
        sp = seq.req.sampling
        self._tables[lane] = self.kv.table(sid, self.max_blocks_per_seq)
        self._ctx[lane] = cached_use
        self._temps[lane] = sp.temperature
        self._top_ks[lane] = sp.top_k
        self._top_ps[lane] = sp.top_p
        self._seeds[lane] = sp.seed
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

    def _mixed_once(self) -> List[GenerationResult]:
        """One mixed step: every decoding lane's next token, then up to
        prefill_chunk prompt tokens per prefilling lane, in token_budget
        slots; the rest spin on the trash block."""
        finished: List[GenerationResult] = []
        # retire sequences whose previous token already ended them
        for lane, seq in enumerate(self._lane_seq):
            if seq is None:
                continue
            done = self._finish_reason(seq)
            if done is not None:
                finished.append(self._retire(lane, done))
        t = self.token_budget
        m = self.max_blocks_per_seq
        # provision every lane's writes (block extension, copy-on-write);
        # under pool pressure evict cold prefixes, then preempt. Re-running
        # _provision after either is idempotent.
        while True:
            try:
                self._provision()
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
        slot = len(decode_lanes)
        chunk_plan = []              # (lane, seq, start, take)
        for ln in prefill_lanes:
            seq = self._lane_seq[ln]
            n = len(seq.req.prompt)
            take = min(self.prefill_chunk, n - seq.prefilled, t - slot)
            if take <= 0:
                continue
            chunk_plan.append((ln, seq, seq.prefilled, take))
            slot += take
        tables = np.full((t, m), TRASH_BLOCK, np.int32)
        positions = np.zeros((t,), np.int32)
        tokens = np.zeros((t,), np.int32)
        # one sampler row per lane: a decode lane's slot, or the last slot
        # of a prefilling lane's chunk; rows of idle lanes read slot 0
        # greedily and are discarded
        sw = self.sample_width
        sample_slots = np.zeros((sw,), np.int32)
        temps = np.zeros((sw,), np.float32)
        tks = np.zeros((sw,), np.int32)
        tps = np.ones((sw,), np.float32)
        seeds = np.zeros((sw,), np.int64)
        steps = np.zeros((sw,), np.int64)
        slot = 0
        for ln in decode_lanes:
            seq = self._lane_seq[ln]
            tables[slot] = self._tables[ln]
            positions[slot] = seq.ctx
            tokens[slot] = seq.generated[-1]
            sample_slots[ln] = slot
            temps[ln] = self._temps[ln]
            tks[ln] = self._top_ks[ln]
            tps[ln] = self._top_ps[ln]
            seeds[ln] = self._seeds[ln]
            # the step is the token's index in its sequence: a replay
            # samples every index exactly as the first run did
            steps[ln] = len(seq.generated)
            slot += 1
        for ln, seq, start, take in chunk_plan:
            sp = seq.req.sampling
            for j in range(take):
                tables[slot] = self._tables[ln]
                positions[slot] = start + j
                tokens[slot] = seq.req.prompt[start + j]
                slot += 1
            # only the last slot's sample counts, and only when the chunk
            # completes the prompt (step 0, the first generated token)
            sample_slots[ln] = slot - 1
            temps[ln] = sp.temperature
            tks[ln] = sp.top_k
            tps[ln] = sp.top_p
            seeds[ln] = sp.seed
            steps[ln] = 0
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
        for ln in decode_lanes:
            seq = self._lane_seq[ln]
            seq.ctx += 1
            self._ctx[ln] = seq.ctx
            seq.generated.append(int(nxt[ln]))
            seq.req.trace.token()
            timer_observe("TIMER_generation_inter_token_us",
                          (now - seq.t_last_token) * 1e6)
            seq.t_last_token = now
            stat_add("STAT_generation_tokens")
            done = self._finish_reason(seq)
            if done is not None:
                finished.append(self._retire(ln, done))
        for ln, seq, start, take in chunk_plan:
            seq.prefilled = start + take
            seq.ctx = seq.prefilled
            self._ctx[ln] = seq.ctx
            seq.req.trace.event("prefill_chunk", start=start, width=take)
            self._publish_prefix(seq)
            if seq.prefilled == len(seq.req.prompt):
                seq.generated.append(int(nxt[ln]))
                seq.req.trace.token()
                seq.t_last_token = now
                stat_add("STAT_generation_tokens")
                done = self._finish_reason(seq)
                if done is not None:
                    finished.append(self._retire(ln, done))
        gauge_set("GAUGE_generation_active_seqs", self.active_count)
        return finished

    def _provision(self) -> None:
        """Make every lane's writes of this step safe: extend a decoding
        lane's table to its next position, and copy-on-write every
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
                lo = hi = seq.ctx
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
        (the device half of copy-on-write)."""
        pools = [self.k_pools, self.v_pools]
        if self.k_scales is not None:
            pools += [self.k_scales, self.v_scales]
        for p in pools:
            p[:, dst] = p[:, src]

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
        completion order (match them by request_id)."""
        for i, r in enumerate(reqs):
            if r.request_id is None:
                r = replace(r, request_id=i)
            self.submit(r)
        out: List[GenerationResult] = []
        steps = 0
        # a prompt takes up to ceil(prompt / chunk) extra steps to stream in
        limit = max_steps if max_steps is not None else \
            (2 * self.cfg.max_seq_len + 4) * max(1, len(reqs))
        while not self.idle and steps < limit:
            out.extend(self.step())
            steps += 1
        if not self.idle:
            raise RuntimeError(f"generation did not converge in {limit} "
                               "steps")
        return out


class NaiveGenerator:
    """The oracle: every new token re-runs ``forward_full`` over the whole
    context, padded to a bucket of the ladder, with the engine's sampler.
    Pass the engine's ``attn_lanes`` to attend over the same lane count."""

    def __init__(self, cfg: DecoderConfig, params: Mapping[str, Any],
                 buckets=None, attn_lanes: int = 0,
                 device: DeviceLike = None):
        from ..jit import load_reference_params
        self.cfg = cfg
        self.device = resolve(device)
        self.params = load_reference_params(cfg, params, self.device)
        spec = buckets if buckets is not None else _NAIVE_BUCKETS
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
