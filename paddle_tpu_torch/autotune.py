"""Adaptive dispatch: the generation engine's step geometry and the
Predictor's bucket-or-exact choice, tuned on measured time.

Counterpart of ``paddle_tpu/autotune.py``. Once a key (shape bucket,
device, quant mode, pins) it

1. lists candidate forms (at most ``FLAGS_autotune_candidates``, the
   default form first);
2. builds a throwaway trial engine a candidate and times interleaved
   passes of a small deterministic probe (``FLAGS_autotune_probe_tokens``
   tokens a pass, a fresh seed each pass, so that no candidate rides the
   prefix cache and machine drift favours none);
3. keeps only the candidates whose token streams, keyed by
   ``request_id``, are bitwise the default form's: a form that changes a
   token can never win;
4. picks the fastest eligible one by time a generated token, installs it
   in the process's ``DispatchPolicy`` and stores it in the program
   cache's policy layer (``core/program_cache.py``), so that a restarted
   process reloads it with no trial.

``DispatchPolicy.resolve`` is one dict lookup. Precedence, as in the JAX
package: an argument or an explicitly set flag pins a knob (the search
varies only the free ones), then comes the stored policy, then the flag's
default.

The search space differs on purpose in one dimension. The JAX package
searches the kernel form (reference | pallas) too. The port's rule is
that a plain version never runs on a CUDA tensor, so the kernel form has
one member, the Hopper kernel ("pallas"), and the search varies geometry
only (block_size x prefill_chunk x token_budget) on every device. On the
CPU "reference" is an alias of "pallas": the wrapper runs the plain
version on a CPU tensor whichever name is given. The JAX package's
``autotune.measure`` failpoint is left out with the failpoints
(``ROADMAP.md`` A7): a trial that raises discards its candidate, and a
default-form trial that raises ends the tune with nothing stored.

Instruments: STAT_autotune_trials / _wins / _cache_hits / _fallbacks,
TIMER_autotune_trial_us; the engine publishes GAUGE_autotune_active /
_step_time_us / _trials for its entry (the scheduler's ``_reset_engine``
republishes them).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .core import program_cache
from .flags import get_flag
from .monitor import stat_add, timer_observe

__all__ = ["CandidateForm", "DispatchPolicy", "generation_candidates",
           "key_for", "policies", "policy", "probe_requests", "reset",
           "resolve_generation", "tune_two_forms", "backend_of"]

# interleaved timing passes a candidate; the best pass is its time
_TRIAL_PASSES = 3


class CandidateForm(NamedTuple):
    """One point of the generation search space; token_budget keeps the
    flag's meaning (0: decode_width * (1 + spec) + chunk)."""
    kernel: str
    block_size: int
    prefill_chunk: int
    token_budget: int

    @property
    def label(self) -> str:
        return "%s/bs%d/pc%d/tb%d" % self

    def as_entry(self) -> Dict[str, Any]:
        return {"kernel": self.kernel, "block_size": self.block_size,
                "prefill_chunk": self.prefill_chunk,
                "token_budget": self.token_budget, "label": self.label}


class DispatchPolicy:
    """The process's table of resolved forms; ``resolve`` is one dict
    lookup."""

    def __init__(self) -> None:
        self._table: Dict[str, Dict[str, Any]] = {}

    def resolve(self, key: str) -> Optional[Dict[str, Any]]:
        return self._table.get(key)

    def install(self, key: str, entry: Dict[str, Any]) -> None:
        self._table[key] = dict(entry)

    def reset(self) -> None:
        self._table.clear()

    def entries(self) -> List[Dict[str, Any]]:
        """Every installed entry, in key order."""
        return [self._table[k] for k in sorted(self._table)]

    def snapshot(self) -> List[Dict[str, Any]]:
        """One row a key: its coordinates, the winning form and its time."""
        out = []
        for k in sorted(self._table):
            e, km = self._table[k], json.loads(k)
            out.append({"kind": km.get("kind"), "backend": km.get("backend"),
                        "qm": km.get("qm"), "kvq": km.get("kvq"),
                        "width": km.get("width"), "rows": km.get("rows"),
                        "bucket": km.get("bucket"), "form": e.get("label"),
                        "step_time_us": e.get("step_time_us"),
                        "us_per_token": e.get("us_per_token"),
                        "trials": e.get("trials"),
                        "source": e.get("source", "tuned")})
        return out


_POLICY = DispatchPolicy()


def policy() -> DispatchPolicy:
    return _POLICY


def policies() -> List[Dict[str, Any]]:
    return _POLICY.snapshot()


def reset() -> None:
    """Clear the in-memory table (the files stay: the next resolve reads
    them)."""
    _POLICY.reset()


def key_for(key_meta: Dict[str, Any]) -> str:
    """The table key of a key meta: sorted JSON, the same in every
    process."""
    return json.dumps(key_meta, sort_keys=True, default=str)


def backend_of(device) -> str:
    """The device part of a key: the card's name, or "cpu"."""
    d = torch.device(device)
    return "cuda:" + torch.cuda.get_device_name(d) if d.type == "cuda" \
        else d.type


def _lookup(key_meta: Dict[str, Any], program_cache_dir: Optional[str]):
    """Memory, then disk: (key, entry or None, cache dir, fingerprint); a
    hit counts STAT_autotune_cache_hits, and a disk hit is installed."""
    key = key_for(key_meta)
    entry = _POLICY.resolve(key)
    if entry is not None:
        stat_add("STAT_autotune_cache_hits")
        return key, entry, None, None
    cache_dir = program_cache.resolve_dir(program_cache_dir)
    fp = None
    if cache_dir is not None:
        fp = program_cache.policy_fingerprint(key_meta)
        entry = program_cache.load_policy(cache_dir, fp)
        if entry is not None:
            stat_add("STAT_autotune_cache_hits")
            _POLICY.install(key, dict(entry, source="disk"))
            entry = _POLICY.resolve(key)
    return key, entry, cache_dir, fp


def _publish(key: str, entry: Dict[str, Any], cache_dir: Optional[str],
             fp: Optional[str]) -> Dict[str, Any]:
    stat_add("STAT_autotune_wins")
    _POLICY.install(key, entry)
    if cache_dir is not None and fp is not None:
        program_cache.store_policy(cache_dir, fp, entry)
    return entry


# --- generation: the candidates and the trials -----------------------------

def generation_candidates(defaults: CandidateForm, pins: Dict[str, Any],
                          budget: int) -> List[CandidateForm]:
    """The candidates, the default form first, cut to ``budget``; a pinned
    knob never varies. Geometry only: the kernel form is the default's
    (one member, the Hopper kernel)."""
    d = defaults
    out = [d]
    variants: List[CandidateForm] = []
    if "prefill_chunk" not in pins and d.prefill_chunk > 0:
        variants += [d._replace(prefill_chunk=d.prefill_chunk * 4),
                     d._replace(prefill_chunk=d.prefill_chunk * 2),
                     d._replace(prefill_chunk=max(1, d.prefill_chunk // 2))]
    if "block_size" not in pins:
        variants += [d._replace(block_size=d.block_size * 2),
                     d._replace(block_size=max(1, d.block_size // 2))]
    for v in variants:
        if len(out) >= budget:
            break
        if v not in out:
            out.append(v)
    return out[:max(1, budget)]


def probe_requests(cfg, decode_width: int, probe_tokens: int,
                   seed: int = 20160829) -> list:
    """The trial workload: a few requests, prompts from a short turn to
    three quarters of the context, sharing ``probe_tokens`` new tokens;
    the same seed gives the same requests."""
    from .generation.engine import GenerationRequest
    from .generation.sampling import SamplingParams
    rng = np.random.default_rng(seed)
    n = max(2, min(int(decode_width), 4))
    msl = int(cfg.max_seq_len)
    new = max(2, int(probe_tokens) // n)
    spread = (2, msl // 4, msl // 2, (3 * msl) // 4)
    reqs = []
    for i in range(n):
        plen = max(1, min(msl - new - 1, spread[i % len(spread)]))
        prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, size=plen)]
        reqs.append(GenerationRequest(
            prompt=prompt, max_new_tokens=new,
            sampling=SamplingParams(temperature=0.7, top_k=5, seed=1000 + i),
            request_id="probe%d" % i))
    return reqs


def _build_trial_engine(cand: CandidateForm, cfg, params,
                        engine_kwargs: Dict[str, Any]):
    """One candidate's trial engine, warmed up; a constructor error
    discards the candidate before it is timed."""
    from .generation.engine import GenerationEngine
    eng = GenerationEngine(cfg, params, autotune=False, kernel=cand.kernel,
                           block_size=cand.block_size,
                           prefill_chunk=cand.prefill_chunk,
                           token_budget=cand.token_budget, **engine_kwargs)
    eng.warmup()
    return eng


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _probe_pass(eng, cfg, probe_tokens: int, seed: int):
    """Serve one probe on a warm engine: (seconds a token, seconds a step,
    the streams by request_id); raises when it does not finish."""
    reqs = probe_requests(cfg, eng.decode_width, probe_tokens, seed=seed)
    limit = ((2 if eng.prefill_chunk else 1) * cfg.max_seq_len + 4) \
        * max(1, len(reqs))
    for r in reqs:
        eng.submit(r)
    results, steps = [], 0
    _sync(eng.device)
    t0 = time.perf_counter()
    while not eng.idle and steps < limit:
        results.extend(eng.step())
        steps += 1
    _sync(eng.device)
    dt = time.perf_counter() - t0
    if not eng.idle:
        raise RuntimeError("trial did not converge in %d steps" % limit)
    streams = {r.request_id: tuple(r.tokens) for r in results}
    tokens = sum(len(v) for v in streams.values())
    return dt / max(1, tokens), dt / max(1, steps), streams


def resolve_generation(cfg, params, *, num_blocks: int, decode_width: int,
                       spec_tokens: int, quant_mode: str, kv_dtype: str,
                       draft_kind: str, device, draft_cfg=None,
                       draft_params=None, prefix_cache=None,
                       program_cache_dir: Optional[str] = None,
                       pins: Optional[Dict[str, Any]] = None
                       ) -> Optional[Dict[str, Any]]:
    """The engine's dispatch: memory, then disk, then a tune. Returns the
    policy entry (kernel, geometry, times), or None when the default form's
    trial failed (the engine then runs the default form, nothing stored)."""
    pins = dict(pins or {})
    dev = torch.device(device)
    key_meta = {
        "kind": "generation", "model": cfg.meta(),
        "width": int(decode_width), "spec": int(spec_tokens),
        "draft": str(draft_kind) if spec_tokens else "",
        "qm": str(quant_mode), "kvq": str(kv_dtype),
        "blocks": int(num_blocks), "backend": backend_of(dev),
        "pins": {k: pins[k] for k in sorted(pins)},
    }
    key, entry, cache_dir, fp = _lookup(key_meta, program_cache_dir)
    if entry is not None:
        return entry
    budget = max(1, int(get_flag("FLAGS_autotune_candidates")))
    probe_tokens = max(4, int(get_flag("FLAGS_autotune_probe_tokens")))
    defaults = CandidateForm(
        kernel=str(pins.get("kernel",
                            get_flag("FLAGS_paged_attention_kernel"))),
        block_size=int(pins.get("block_size",
                                get_flag("FLAGS_generation_block_size"))),
        prefill_chunk=int(pins.get(
            "prefill_chunk", get_flag("FLAGS_generation_prefill_chunk"))),
        token_budget=int(pins.get(
            "token_budget", get_flag("FLAGS_generation_token_budget"))))
    cands = generation_candidates(defaults, pins, budget)
    engine_kwargs = dict(num_blocks=num_blocks, decode_width=decode_width,
                         spec_tokens=spec_tokens, quant_mode=quant_mode,
                         kv_dtype=kv_dtype, draft=draft_kind,
                         draft_cfg=draft_cfg, draft_params=draft_params,
                         prefix_cache=prefix_cache, device=dev)

    # every candidate's engine is built and warmed first; a failure
    # discards it, and the default form's ends the tune
    t_tune = time.perf_counter()
    bad: Dict[int, Dict[str, Any]] = {}
    built: List[list] = []          # [i, cand, engine, seconds]
    for i, cand in enumerate(cands):
        stat_add("STAT_autotune_trials")
        t0 = time.perf_counter()
        try:
            eng = _build_trial_engine(cand, cfg, params, engine_kwargs)
        except Exception as e:  # the candidate is discarded, and reported
            timer_observe("TIMER_autotune_trial_us",
                          (time.perf_counter() - t0) * 1e6)
            stat_add("STAT_autotune_fallbacks")
            if i == 0:
                return None
            bad[i] = dict(cand.as_entry(), eligible=False,
                          error=repr(e)[:160])
            continue
        built.append([i, cand, eng, time.perf_counter() - t0])

    # interleaved passes, a fresh probe seed each
    meas: Dict[int, Dict[str, Any]] = {}
    for p in range(_TRIAL_PASSES):
        for rec in built:
            i, cand = rec[0], rec[1]
            if i in bad:
                continue
            t0 = time.perf_counter()
            try:
                s_tok, s_step, streams = _probe_pass(
                    rec[2], cfg, probe_tokens, seed=20160829 + p)
            except Exception as e:  # the candidate is discarded, reported
                rec[3] += time.perf_counter() - t0
                stat_add("STAT_autotune_fallbacks")
                if i == 0:
                    return None
                bad[i] = dict(cand.as_entry(), eligible=False,
                              error=repr(e)[:160])
                meas.pop(i, None)
                continue
            rec[3] += time.perf_counter() - t0
            m = meas.setdefault(i, {"s_tok": s_tok, "s_step": s_step,
                                    "streams": {}})
            m["streams"][p] = streams
            if s_tok < m["s_tok"]:
                m["s_tok"], m["s_step"] = s_tok, s_step
    for rec in built:
        timer_observe("TIMER_autotune_trial_us", rec[3] * 1e6)
    del built  # the trial engines' pools go back to the allocator

    records: List[Dict[str, Any]] = []
    ref_streams = meas[0]["streams"]
    for i, cand in enumerate(cands):
        if i in bad:
            records.append(bad[i])
            continue
        m = meas.get(i)
        if m is None:
            continue
        # the bitwise gate: every pass's streams equal the default form's
        eligible = m["streams"] == ref_streams
        if i and not eligible:
            stat_add("STAT_autotune_fallbacks")
        records.append(dict(cand.as_entry(), eligible=eligible,
                            us_per_token=round(m["s_tok"] * 1e6, 2),
                            step_time_us=round(m["s_step"] * 1e6, 2)))
    win = min((r for r in records if r.get("eligible")),
              key=lambda r: r["us_per_token"])
    entry = {"kernel": win["kernel"], "block_size": win["block_size"],
             "prefill_chunk": win["prefill_chunk"],
             "token_budget": win["token_budget"], "label": win["label"],
             "us_per_token": win["us_per_token"],
             "step_time_us": win["step_time_us"], "trials": len(records),
             "candidates": records,
             "tuned_s": round(time.perf_counter() - t_tune, 3),
             "source": "tuned"}
    return _publish(key, entry, cache_dir, fp)


# --- two named forms (the Predictor's bucket dispatch) ---------------------

def tune_two_forms(key_meta: Dict[str, Any], *,
                   program_cache_dir: Optional[str],
                   forms: Dict[str, Callable[[], Any]], reference: str,
                   compare: Callable[[Any, Any], bool],
                   passes: int = 3) -> Optional[Dict[str, Any]]:
    """Tune among named zero-argument forms that do the same work: passes
    in turns, the winner the eligible form with the best pass, eligible
    when ``compare(reference's value, its value)``. A failing reference
    ends the tune (None, nothing stored); another failing form is
    dropped."""
    key, entry, cache_dir, fp = _lookup(key_meta, program_cache_dir)
    if entry is not None:
        return entry
    order = [reference] + [n for n in forms if n != reference]
    best: Dict[str, float] = {}
    values: Dict[str, Any] = {}
    failed: set = set()
    for _ in range(max(1, passes)):
        for name in order:
            if name in failed:
                continue
            stat_add("STAT_autotune_trials")
            t0 = time.perf_counter()
            try:
                val = forms[name]()
            except Exception:  # the form is dropped (the reference: no tune)
                timer_observe("TIMER_autotune_trial_us",
                              (time.perf_counter() - t0) * 1e6)
                stat_add("STAT_autotune_fallbacks")
                if name == reference:
                    return None
                failed.add(name)
                continue
            dt = time.perf_counter() - t0
            timer_observe("TIMER_autotune_trial_us", dt * 1e6)
            if name not in best or dt < best[name]:
                best[name] = dt
            values.setdefault(name, val)
    eligible = {}
    for name, dt in best.items():
        if name == reference or compare(values[reference], values[name]):
            eligible[name] = dt
        else:
            stat_add("STAT_autotune_fallbacks")
    win = min(eligible, key=eligible.get)
    entry = {"form": win, "label": win,
             "step_time_us": round(eligible[win] * 1e6, 2),
             "trials": sum(1 for n in order if n not in failed) *
             max(1, passes),
             "candidates": [{"label": n, "step_time_us":
                             round(best[n] * 1e6, 2),
                             "eligible": n in eligible}
                            for n in order if n in best],
             "source": "tuned"}
    return _publish(key, entry, cache_dir, fp)
