"""Token samplers: greedy, temperature, top-k and top-p, one batched call.

Counterpart of ``paddle_tpu/generation/sampling.py``. Greedy is argmax;
temperature, top-k and top-p follow the reference expression for
expression: scale by 1/max(T, 1e-6), keep scores >= the k-th of a
descending sort, then keep the tokens whose exclusive cumulative
probability (in descending order, stable) is below top_p, so the token
that crosses top_p stays and at least one always does.

The draw differs from the reference, whose threefry
``fold_in(PRNGKey(seed), step)`` torch cannot reproduce. It is Gumbel-max:
argmax(filtered + g) with g = -log(-log(u)), u = (w + 0.5) / 2^32 and w
word 0 of Philox4x32-10 (``kernels.flash_attention.philox4x32_10``) with
counter (vocab index, step, 0, 0) and the seed as key, in float64. So a
sample is a pure function of (logits, seed, step) on every device and in
every batch, which keeps the reference's determinism contract: an evicted
and replayed sequence regenerates its tokens, and batch-mates do not
change them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.flash_attention import philox4x32_10

__all__ = ["SamplingParams", "sample_tokens", "filter_logits"]

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF


@dataclass(frozen=True)
class SamplingParams:
    """temperature <= 0 is greedy (top_k, top_p and seed unused); top_k 0
    and top_p 1.0 disable their filters; the two compose, k first."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")


def _gumbel_noise(seeds: torch.Tensor, steps: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """Float64 Gumbel noise ``[B, vocab]``: row b from Philox4x32-10 with
    key seeds[b] and counter (index, steps[b], 0, 0)."""
    dev = seeds.device
    seeds = seeds.long()[:, None]
    idx = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :]
    full = (seeds.shape[0], vocab)
    counter = (idx.expand(full), (steps.long()[:, None] & _MASK32)
               .expand(full), torch.zeros(full, dtype=torch.int64,
                                          device=dev),
               torch.zeros(full, dtype=torch.int64, device=dev))
    key = (seeds & _MASK32, (seeds >> 32) & _MASK32)
    word = philox4x32_10(counter, key)[0]
    u = (word.double() + 0.5) / 4294967296.0
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, temps, top_ks, top_ps, seeds, steps
                  ) -> torch.Tensor:
    """Batched sampler: logits ``[B, V]``; temps, top_ks, top_ps, seeds and
    steps ``[B]`` (numpy arrays or host tensors; ``steps`` is each row's
    own token index). Returns ``[B]`` int64 tokens on the logits' device.
    The filters and the draw run only when some row samples."""
    dev = logits.device
    logits = logits.float()
    b, v = logits.shape
    temps_host = np.asarray(temps, np.float32).reshape(b)
    greedy = logits.argmax(dim=-1)
    if not (temps_host > 0.0).any():
        return greedy

    def on_dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).reshape(b).to(dev)
    temp = on_dev(temps_host, torch.float32)
    filtered = filter_logits(logits, temp, on_dev(top_ks, torch.int64),
                             on_dev(top_ps, torch.float32))
    g = _gumbel_noise(on_dev(seeds, torch.int64), on_dev(steps, torch.int64),
                     v)
    sampled = (filtered.double() + g).argmax(dim=-1)
    return torch.where(temp <= 0.0, greedy, sampled)


def filter_logits(logits: torch.Tensor, temp: torch.Tensor, k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """The scores the draw sees, ``[B, V]``: logits / max(T, 1e-6) with
    the tokens outside top-k, then outside top-p, set to -1e30."""
    v = logits.shape[-1]
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    k = torch.clamp(torch.where(k == 0, torch.full_like(k, v), k), 1, v)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (k - 1)[:, None])
    neg = torch.full_like(scaled, _NEG_INF)
    filtered = torch.where(scaled >= kth, scaled, neg)
    probs = torch.softmax(filtered, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    ps = probs.gather(1, order)
    keep_sorted = torch.cumsum(ps, dim=-1) - ps < top_p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    return torch.where(keep, filtered, neg)
