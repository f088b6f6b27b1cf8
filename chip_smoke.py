#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero:

1. setup: the card's name and power limit, TF32 off, the CUDA kernels
   built from ``paddle_tpu_torch/csrc`` with nvcc for sm_90a;
2. kernel parity: each CUDA kernel against its plain PyTorch version on
   the card, at BERT-base shapes, with stated tolerances; every compiled
   instance of the flash forward (dtype x D 64, 128, 256 x dropout mode x
   bias layout), seed mode bitwise equal to mask mode with
   ``philox_keep_mask`` and two wrong dropouts shown to fail the
   tolerance; then the routes, through the port's entry points on the
   card, with the path logs and launch counts read back:
   ``MultiHeadAttention(256, 8)`` (head dim 32, "composed", as the JAX
   router composes it) and ``MultiHeadAttention(512, 2)`` (head dim 256,
   "flash": one forward, dQ and dK/dV launch) in fp32 with and without
   seed dropout, forward and every gradient against the CPU port; head dim
   256 forward under bf16 ``auto_cast`` against the fp32 CPU port; a
   2-layer BERT forward under ``auto_cast(dtype="float16")`` ("flash",
   the fp16 instances) against the fp32 CPU port; and layer norms over
   8192 features and in fp16 ("kernel", one launch each way), forward and
   backward against the CPU port;
3. serving, the main path: BERT-base at full width (``BertConfig()``),
   weights from a numpy seed carried in by ``load_reference_state``,
   answers requests in eval mode in fp32 and under bf16 ``auto_cast``.
   Launch counts are set to 0 before and read after; every forward must
   launch the flash kernel 12 times and the layer-norm kernel 26 times,
   and the attention and layer-norm path logs must read "flash" and
   "kernel" only; the forward copies none of its inputs (the
   projection's views are aligned). The fp32
   logits are held against the same model on the CPU (plain versions),
   and the bf16 MLM argmax against fp32;
4. times, printed only: each kernel against its bound, its plain version
   and the one PyTorch call that computes the same function (the flash
   forward also at the train shape, with and without seed dropout, and at
   head dim 256 in each dtype); the
   end-to-end forward per request shape, with its device time from a CUDA
   graph and a torch.profiler breakdown of device time by kernel group;
5. training, the second main path:
   (i) kernel parity of the layer-norm backward, the flash dQ and dK/dV
   kernels and the forward's dropout (explicit keep mask and in-kernel
   Philox, whose pattern is held bit for bit against
   ``philox_keep_mask``, with its drop rate; each kernel in seed mode is
   bitwise equal to itself in mask mode with ``philox_keep_mask``, and
   the tolerances are shown to fail two wrong dropouts; the bf16 backward
   at the train shape with seed dropout gives the same bits twice, and
   copies only the misaligned inputs before its launch);
   (ii) one fp32 ``TrainStep`` with Adam on the card against the CPU
   port: loss, every gradient, every parameter after the update;
   (iii) the main path: BERT-base at full width with dropout on, B=32,
   S=512, 80 masked positions, ``Adam(1e-4)``, bf16 ``auto_cast``, 10
   steps on one batch (the JAX package's bench.py configuration), counts
   set to 0 before and read after: 26 layer-norm forward and backward,
   12 flash forward, dQ and dK/dV launches a step and no forward input
   copied, all-"flash" and all-"kernel" path logs, finite gradients for
   every parameter, a falling loss; a rerun
   from the same seed draws the same dropout; one fp32 step at B=8 S=512
   with the padding mask;
   (iv) times: each new kernel against its bound, its plain version and
   the library call (the flash backward pair also at the main path's call,
   seed dropout 0.1, against SDPA's backward with dropout_p=0.1, with its
   tiling, and at head dim 256 in each dtype); the train step's eager ms,
   tokens/s, MFU and device idle
   share, with a profiler breakdown;
6. the BERT training recipe ("[recipe]" lines), the fourth main path:
   (i) two fp32 ``TrainStep`` steps of AdamW(0.01) and of Lamb(0.01) +
   ``L2Decay(1e-4)``, each with ``GradientClipByGlobalNorm(1.0)`` under
   warmup into a linear decay, on the card against the CPU port (loss,
   lr, clip factor, every clipped gradient, every parameter after each
   step); an inf in the fp16 flash backward's dO and the layer-norm
   backward's dy gives non-finite gradients; (ii) the main path: the eager
   dygraph loop under ``auto_cast(dtype="float16")`` with ``GradScaler``
   at B=32 S=512 M=80, dropout on, 10 steps, counts set to 0 before and
   read after: 26 layer-norm forward and backward, 12 flash forward, dQ
   and dK/dV launches a step, the flash kernels on fp16, all-"flash" and
   all-"kernel" path logs, falling losses, the scale sequence; (iii) the
   same loop from a loss scale of 2^32 that overflows: each skipped step
   leaves every parameter, accumulator and the schedule's step bitwise
   unchanged, the scale follows the rule; (iv) times of the recipe's steps
   beside the plain ``Adam(1e-4)`` step: step ms, device ms, kernels and
   host syncs a step;
7. the static Program path ("[static]" lines), the fifth main path: the
   12-layer BERT-base-shaped train program of
   ``tools/check_backward_replay.py:89`` (H 768, FF 3072, 12 heads, S 128,
   B 8, Adam(1e-4), fp32) built with the port's ``layers`` and run by its
   ``Executor`` in three forms from one startup state: (a) as built
   (attention of mul/matmul/softmax, norms composed over S x H: no
   launch), (b) after ``multihead_matmul_fuse`` (the flash forward, dQ and
   dK/dV 12 times each a step), (c) (b) with ``begin_norm_axis=2`` (the
   layer-norm forward and backward 24 times each a step on top); (a) and
   (c) on the card against the CPU port (loss, every ``@GRAD``, the
   parameters after the update), (b) against (a) on the card, the exact
   launches, path logs and op lowerings of each form's step (each op once:
   no second forward), the main path of ten steps of (c) with counts set to
   0 before and read after, a bitwise rerun, the verify skill's recipe,
   and each form's step ms, device ms, kernels and idle share;
8. generation, the third main path: the decoder of docs/generation.md
   at full width and depth (vocab 32000, hidden 1024, 16 layers, 16
   heads; weights from ``init_params`` through ``load_reference_params``):
   (i) both paged-attention kernels (fp32, int8 and fp8 pools; Cq 1 and
   4; bs 16 and 32; D 16, 64, 128 and 256; and rows of 640 positions)
   against the plain version, with ragged lengths, trash-block rows and
   garbage in every row no query sees; (ii) the main path: 32 requests
   (prompts 16-448 tokens, half greedy, four sharing a 256-token prefix)
   through ``GenerationPool``
   over an engine of 1024 blocks of 16 tokens, 16 lanes and 64-token
   chunks, once with fp32 and once with int8 KV; counts set to 0 before
   and read after: 16 paged launches and 33 layer-norm launches a mixed
   step, an all-"cuda" path log; a rerun gives the same streams; (iii)
   paged logits against ``forward_full`` recompute (fp32 within 1e-3;
   int8 within tests/test_quantized_serving.py's budget), greedy tokens
   against the recompute's argmax, one mixed step against the CPU port;
   (iv) times: the paged kernels against their bound, plain version and
   gather + SDPA; tokens/s, mixed-step, TTFT and TPOT quantiles, and the
   device idle share and the paged-attention group's device ms a mixed
   step over profiled mixed steps, in fp32 and int8 KV; then the rest of
   the engine, each run through ``GenerationPool`` with counts set to 0
   before and read after: (i) the two-phase engine (``prefill_chunk=0``,
   the ``pow2:512`` ladder) on the main path's requests: 16 paged and 33
   layer-norm launches a decode step, 33 layer-norm and no paged launch a
   prefill, its streams against the chunked engine's (equal, or parting
   first at a near tie of the full recompute: ``NEAR_TIE``), its decode
   logits against full recompute, its times beside the chunked engine's;
   (ii) the ngram drafter, k = 4, on prompts of a repeated 16-token
   pattern: proposals, no draft fault, streams against the plain
   engine's; (iii) the model drafter (the target itself) on 8 greedy
   requests: acceptance above 0.9, the drafter's paged launches 16 a draft
   call, streams against the plain engine's; (iv) int8 and fp8 weights
   (KV auto -> int8): logits against fp32 over 8 contexts beside the JAX
   package's budget, the main path's requests with their launches and
   ``GAUGE_quant_weight_bytes_saved``, 4 x 16 + 1 ``torch._int_mm`` calls a
   mixed step (profiler), one int8 mixed step against the CPU port (the
   card's activation codes replayed on the CPU), and one ``qmatmul`` at the
   decoder's shapes against the fp32 matmul;
9. ResNet-50 ("[resnet]" lines), the sixth main path, which launches
   none of the seven kernels (no TPU kernel lies on it: the convolutions
   are cuDNN's, batch norm and pooling torch ops): (i) resnet50 at B=4,
   224 x 224, on the card against the CPU port from one numpy state, in
   float64 and in fp32 (TF32 off): eval logits, one Momentum(0.1, 0.9)
   ``TrainStep``'s loss, every gradient, running statistic and parameter
   after, and the ReLU inputs on the other side of 0 from the float64
   run; (ii) the static conv -> batch_norm(relu) -> pool2d -> fc program,
   one step on the card against the CPU port, its moving statistics
   moved and each op lowered once; (iii) the main path, ``bench.py``'s
   cell: B=256 bf16 ``TrainStep`` steps on one batch, the seven kernels'
   counts set to 0 before and read after, eager and device ms, images/s,
   MFU, device time by group, batch norm's bytes bound, peak memory, and
   a bitwise rerun at B=32 under ``cudnn.deterministic``; (iv) the bf16
   eval forward at B=256: images/s, CUDA-graph device ms, top-1 against
   fp32; (v) a stage-1 batch norm against cuDNN's (timed only) and the
   step in ``channels_last``;
10. Paddle Inference ("[inference]" lines), the seventh main path: the
   BERT-base encoder of Paddle 1.8's static BertModel (``BertConfig()``'s
   widths, 12 layers; ``build_bert_encoder``) built with the port's
   ``layers``, weights from a numpy seed, saved by ``io.save_inference_
   model`` and served by ``inference.create_predictor``: (i) fp32 with the
   pass pipeline on, the card against the CPU port at B=2, and off against
   on; (ii) one eager forward at B=8, counts set to 0 before and read
   after: 12 flash and 25 layer-norm forward launches with the pipeline on,
   0 and 25 off, "flash" and "kernel" path logs only; (v) the main path:
   a ``PredictorPool`` over a ``pow2:32`` ladder, its warmup capturing one
   CUDA graph a bucket (largest first, one shared pool), then 4 client
   threads x 32 requests of 1-8 rows with lengths 16-128 under the mask,
   counts set to 0 before the warmup and read after the traffic (each
   bucket's cold run and capture; replays launch from the graph), each
   answer against the request alone; (iii) requests of 3, 8 and 17 rows
   against their exact-shape eager runs, each bucket's replay bitwise
   against the eager run of its bucket, and one replay's kernels counted
   from a profiler trace (12 flash, 25 layer-norm forward); (iv)
   ``enable_bf16`` against fp32 in relative norm, on the bf16 instances;
   and phase 8's (v) on this bundle: ``Config.enable_quant("int8")``, the
   scope's int8 weights and fp32 scales, the output within the JAX
   package's budget against fp32, each bucket's replay (the dequant ops in
   the graph) bitwise against its eager run; (vi) times: eager, replay
   and device ms at B=1, 8 and 32 in fp32 and bf16, the pool's requests/s, rows/s, latency p50/p95 and idle share,
   peak memory, and the two kernels at this path's calls;
10b. serving artifacts, warm starts and autotune ("[artifact]" lines):
   the BERT-base encoder bundle exported fp32 with a static batch of 8
   (a trace of the cached module) and a dynamic one (a cold Predictor of
   the program cache, whose forward that export is) and bf16 (static 8),
   each artifact's kernel ops (25 layer-norm, 12 flash forwards) and
   shipped libraries checked; the main path: the three served by a process
   that cannot import paddle_tpu_torch, paddle_tpu or jax, counts set to
   0 there before one eager forward and read after, every replay at B=1
   and 8 bitwise its eager run, fp32 against the Predictor and bf16
   against the bf16 Predictor, eager and replay ms beside the Predictor's;
   the C client (when the Python has a shared libpython) bitwise
   ``SerializedCore`` and its ms a request; a warm Predictor in a fresh
   process, no pass and no export, bitwise the cold one, construction
   seconds cold, warm and without the cache; the Predictor's bucket
   choice tuned at B=3; the 16-layer decoder's geometry tuned (3
   candidates, a 32-token probe) and reloaded by a fresh engine with no
   trial, ``kernel="reference"`` raising on the card; each custom op's
   dispatch cost over its wrapper;
11. static-graph training ("[static-train]" lines), the eighth main path:
   (i) Fluid's MNIST LeNet (``examples/fluid_mnist.py``'s network through
   the port's ``fluid``, B=64) under ``CUDAPlace(0)``: one step against
   ``CPUPlace()`` (loss, every ``@GRAD``, every persistable after), then
   ten Adam steps on the MNIST reader's synthetic corpus through
   ``DataFeeder``, the loss falling, the accuracy fetched, each op lowered
   once a step; (ii) three steps on LeNet of each newly ported update rule
   (Lamb, LarsMomentum, Adagrad, DecayedAdagrad, Adamax, Adadelta,
   centered RMSProp, Ftrl, DpSGD), of ``LookaheadOptimizer(SGD, k=2)``
   and of AdamW and Lamb under ``GradientClipByGlobalNorm(1.0)``,
   ``L2Decay`` and a warmup into ``PolynomialDecay``, card against CPU
   port: loss, lr, every (clipped) gradient and every persistable after
   each step; (iii) form (d): the BERT-shaped program of phase 7 with
   ``begin_norm_axis=2``, ``multihead_matmul_fuse`` on its forward, then
   ``contrib.mixed_precision.decorate(Adam(1e-4),
   AutoMixedPrecisionLists(custom_white_list=["multihead_matmul"]))``:
   one bf16 and one fp16 step against the CPU port's run of it (B=2) and
   against the card's fp32 form (c) (B=8), in gradient norm, with a wrong
   variant (fp16 from a loss scale of 1, whose backward underflows) shown
   to fail the tolerances; the main path: ten bf16 steps at B=8 S=128
   with counts set to 0 before and read after: 12 flash forward, dQ and
   dK/dV launches on bf16 and 24 layer-norm forward and backward on
   float32 rows a step, no forward input copied, all-"flash" and
   all-"kernel" path logs, falling losses, a bitwise rerun; (iv) fp16 with
   dynamic loss scaling: ten steps from 2^15 on the fp16 instances, and a
   run from a scale at which the backward overflows (2^32 up), card and
   CPU port: zeroed gradients, update ops still run, the scale and
   counters by the rule and equal across the two; (v) (d) with recompute
   segments at each layer's output against (d) without: loss and every
   gradient bitwise, the launches (the flash forward and the norms'
   forward again in the backward), the peak memory of each; (vi) times:
   step ms, device ms, kernels and idle share of (c) fp32, (d) bf16, (d)
   fp16 and (d) with recompute; the bf16 and fp16 flash forward, dQ and
   dK/dV at [8,12,128,64] against their bound and SDPA;
12. sparse embeddings, LoD feeds, lazy fetches and static control flow
   ("[sparse-cf]" lines), the ninth and tenth main paths, neither of
   which launches one of the seven kernels (no Pallas kernel lies on
   them): (i) Wide&Deep at ``WideDeep()``'s widths (100,000 x 16 sparse
   table, 26 slots, 13 dense features, fc 400-400-400) at B=1024, ids
   Zipf(1.2): one Adam step on the card against the CPU port (loss, every
   gradient, the table's merged SelectedRows, every parameter after),
   three steps each of SGD, Momentum, Adagrad, AdamW and Lamb, fp16
   ``GradScaler`` with an overflow step and a step whose unscaled sparse
   values are held in norm; the main path: 20 Adam steps, counts set to 0
   before and read after, never densifying the table, its untouched rows
   bitwise unchanged, a bitwise rerun; times, unique rows and the bytes
   the lazy update touches; (ii) the two-layer LSTM language model of
   Zaremba et al. 2014 ("medium": vocab 10,000, hidden 650, 35 steps,
   batch 20, dropout 0.5) through ``layers.StaticRNN``: one step against
   the CPU port with the same dropout masks, the main path of ten steps
   with lazy fetches (counts set to 0 before, read after) against an
   eager-fetch run, one sync a read, a static ExponentialMovingAverage
   applied to one eval pass, times with op lowerings and host syncs a
   step; (iii) the programs of ``tests/test_control_flow.py``
   (``CF_CASES``) on the card against the CPU port and their expected
   values, with their host reads, and three LeNet steps of
   ``proximal_gd``, ``proximal_adagrad`` and a static ``ModelAverage``;
13. one JSON line of kernel records, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks at a 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores, dense
              torch.float16: 989e12,
              torch.float32: 67e12}     # CUDA cores, no TF32

SEED = 1234
MASKED_PER_ROW = 20
# (name, batch, seq, padded): padded rows have lengths 64..S, a padding
# mask and MASKED_PER_ROW masked positions each
REQUESTS = (("b8_s128_full", 8, 128, False),
            ("b8_s512_padded", 8, 512, True),
            ("b1_s384", 1, 384, False),
            ("b1_s77", 1, 77, False))

# Tolerances of the kernel/plain comparisons on the card. fp32: the same
# arithmetic summed in another order, errors of a few ulps of O(1) values.
# bf16 outputs: both sides round nearly the same fp32 value to bf16 (the
# tensor-core flash kernel also rounds p to bf16 before p v), so they may
# differ by a rounding step, up to 2^-7 relative; two steps are allowed.
# fp16 layer-norm outputs: the same rule at fp16's 2^-10 step (two steps,
# 2^-9). The fp16 flash kernel rounds each p to fp16 (at most 2^-11 of p)
# before p v and o once: |o - ref| <= 2^-11 (max|v| / keep_prob + |o|),
# with |v| < 6 for these normal inputs and keep_prob 0.9: A 2^-8, R 2^-10.
LN_TOL = {torch.float32: dict(y=(2e-5, 2e-5), mean=(1e-5, 1e-5),
                              rstd=(0.0, 1e-5)),
          torch.bfloat16: dict(y=(2.0 ** -9, 2.0 ** -6), mean=(1e-5, 1e-5),
                               rstd=(0.0, 1e-5)),
          torch.float16: dict(y=(2.0 ** -12, 2.0 ** -9), mean=(1e-5, 1e-5),
                              rstd=(0.0, 1e-5))}
FLASH_TOL = {torch.float32: dict(o=(1e-5, 1e-5), lse=(1e-5, 1e-5)),
             torch.bfloat16: dict(o=(2.0 ** -9, 2.0 ** -6),
                                  lse=(1e-4, 1e-5)),
             torch.float16: dict(o=(2.0 ** -8, 2.0 ** -10),
                                 lse=(1e-4, 1e-5))}
# fp32 GPU logits against the CPU port: 12 layers summed in other orders;
# logits are O(1), so 1e-3 leaves two orders of magnitude over fp32 noise
CPU_TOL = dict(atol=1e-3, rtol=1e-3)
# bf16 MLM argmax against fp32 over a 30522-way vocabulary of random
# weights, whose top two logits are often close
ARGMAX_AGREEMENT_MIN = 0.80


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str):
    """'kernel<D>: N regs, spill S bytes' for each kernel of a ptxas -v
    log (mangled names shortened to the kernel's name and first template
    argument)."""
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            # the kernel's name is the shortest length-prefixed name
            # ending in _kernel (a hash before the length may end in
            # digits too, and a longer run may parse as a name)
            short = min(
                (re.match(r"(\w{%d})(?:I(.*?)EEv)?" % int(n.group()[j:]),
                          mangled[n.end():])
                 for n in re.finditer(r"\d+", mangled)
                 for j in range(len(n.group()))
                 if re.fullmatch(r"[a-z]\w*_kernel", mangled[
                     n.end():n.end() + int(n.group()[j:])])),
                key=lambda m: len(m.group(1)), default=None)
            kernel = mangled
            if short:
                names = {"f": "f32", "a": "int8", "__nv_bfloat16": "bf16",
                         "__half": "fp16", "__nv_fp8_e4m3": "fp8"}
                args = [names.get(a.group(1) or a.group(0)) or a.group(2)
                        or a.group(3)
                        for a in re.finditer(r"\d+(__nv_bfloat16|__half|"
                                             r"__nv_fp8_e4m3)|Li(\d+)E|"
                                             r"Lb(\d)E|f|a",
                                             short.group(2) or "")]
                args = [a for a in args if a is not None]
                kernel = short.group(1) + \
                    (f"<{','.join(args)}>" if args else "")
            spill = None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append(f"{kernel}: {m.group(1)} regs, spill {spill} B")
            kernel = None
    return out


def max_err(got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float):
    """(max |got - want|, whether |got - want| <= atol + rtol |want|)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.all(diff <= atol + rtol * w.abs()))
    return float(diff.max()), ok


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def ln_inputs(rows, f, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, f, generator=g) * 2.0 + 0.5
    gamma = 1.0 + 0.1 * torch.randn(f, generator=g)
    beta = 0.1 * torch.randn(f, generator=g)
    return (x.to(dtype).to(device), gamma.to(device), beta.to(device))


def padding_bias(batch, seq, device, seed, lo=64):
    """The BERT padding mask: additive fp32 [B, 1, 1, S], finfo.min where
    a key is padding; row lengths drawn from lo..seq."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(min(lo, seq), seq + 1, (batch,), generator=g)
    keep = (torch.arange(seq)[None, :] < lens[:, None]).float()
    bias = (1.0 - keep)[:, None, None, :] * torch.finfo(torch.float32).min
    return bias.to(device)


def attn_inputs(b, h, sq, sk, d, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, h, s, d, generator=g).to(dtype).to(device)
                 for s in (sq, sk, sk))


def random_state(model, seed):
    """Numpy weights for every name of the model: N(0, 0.02) like BERT's
    initializer_range, layer-norm scales 1 + N(0, 0.1) and shifts
    N(0, 0.1), so that the layer-norm kernel sees non-trivial gamma and
    beta."""
    from paddle_tpu_torch.jit import state_of
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in state_of(model).items():
        z = rng.standard_normal(tuple(t.shape), dtype=np.float32)
        is_norm = ".layer_norm." in name or ".norm1." in name or \
            ".norm2." in name
        if is_norm and name.endswith("weight"):
            state[name] = 1.0 + 0.1 * z
        elif is_norm:
            state[name] = 0.1 * z
        else:
            state[name] = 0.02 * z
    return state


def make_request(batch, seq, padded, vocab, device, rng):
    ids = rng.integers(0, vocab, (batch, seq))
    types = (np.arange(seq)[None, :] >= seq // 2).repeat(batch, 0)
    req = dict(input_ids=torch.from_numpy(ids).to(device),
               token_type_ids=torch.from_numpy(types.astype(np.int64))
               .to(device))
    if padded:
        lens = rng.integers(64, seq + 1, batch)
        lens[0] = seq
        mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.float32)
        pos = np.stack([np.sort(rng.choice(int(n), MASKED_PER_ROW,
                                           replace=False)) for n in lens])
        req["attention_mask"] = torch.from_numpy(mask).to(device)
        req["masked_positions"] = torch.from_numpy(pos).to(device)
    return req


# ---------------------------------------------------------------------------
# bounds and timing
# ---------------------------------------------------------------------------

def bound_ms(nbytes: float, flops: float, dtype):
    """(least time in ms, "bytes" or "operations") at the H100 peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def ln_work(x, gamma):
    rows, f = x.shape
    nbytes = 2 * x.numel() * x.element_size() + \
        2 * f * gamma.element_size() + 2 * rows * 4
    flops = 8 * x.numel()  # sum, centre, square, sum, scale, shift
    return nbytes, flops


def attn_work(q, k, bias, causal):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if causal:  # key j visible to query i when i + sk - sq >= j
        rows = torch.arange(sq) + (sk - sq)
        pairs = int(torch.clamp(rows + 1, 0, sk).sum())
    else:
        pairs = sq * sk
    flops = 4 * b * h * pairs * d
    nbytes = (q.numel() + 2 * k.numel()) * q.element_size() + \
        q.numel() * q.element_size() + b * h * sq * 4
    if bias is not None:
        nbytes += b * sk * 4  # the [B, 1, 1, S] padding mask
    return nbytes, flops


def device_ms(fns, reps=10):
    """Device time of one call in ms: a CUDA graph of ``reps`` rounds over
    ``fns`` (each on its own inputs, so that from one call to the next the
    50 MB L2 cache does not hold them), replayed between CUDA events. The
    graph leaves out the host's launch overhead, which is the end-to-end
    numbers' business."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def copies(make, per_copy_bytes):
    """Enough input sets (at most 8) that together they pass 100 MB, twice
    the L2 cache."""
    n = max(1, min(8, math.ceil(100e6 / max(per_copy_bytes, 1))))
    return [make(i) for i in range(n)]


# ---------------------------------------------------------------------------
# phase 2: kernel parity
# ---------------------------------------------------------------------------

# other code paths of the kernels, beyond BERT-base's shapes: (rows, F)
# with F not a multiple of 4 (scalar loads), F > 1024 (a block per row),
# bf16 and fp16 gamma/beta, fp16 x, and rows past 4096 values (the
# forward's wide kernel; the backward's clusters past 8192, scalar loads,
# the widest row)
LN_EDGE_CASES = ((7, 130, torch.float32, False), (7, 130, torch.bfloat16, False),
                 (5, 4096, torch.bfloat16, True), (3, 2050, torch.float32, False),
                 (7, 130, torch.float16, False),
                 (64, 768, torch.float16, False),
                 (5, 4096, torch.float16, True),
                 (1030, 8192, torch.float32, False),
                 (5, 8194, torch.bfloat16, True),
                 (3, 65536, torch.float16, True),
                 # the backward's grid (kernels/layer_norm.py bwd_grid):
                 # fewer rows than a full wave's CTAs, a last CTA with 1
                 # row of 8, and 17 rows a CTA with 10 in the last
                 (100, 768, torch.float32, False),
                 (1001, 768, torch.bfloat16, False),
                 (2203, 1024, torch.float32, False)) + tuple(
    # each side of every bucket of the backward's instances
    # (bwd_instance): the upper side is never a multiple of 4, nor is 3 in
    # the first bucket
    (37, f, dt, w16) for f, dt, w16 in (
        (3, torch.float32, False),
        (128, torch.float32, False), (129, torch.bfloat16, False),
        (256, torch.float16, False), (257, torch.float32, False),
        (384, torch.bfloat16, True), (385, torch.float16, False),
        (512, torch.float32, False), (513, torch.bfloat16, False),
        (768, torch.float16, True), (769, torch.float32, False),
        (1024, torch.bfloat16, False), (1025, torch.float32, False),
        (2048, torch.float16, False), (2049, torch.bfloat16, True),
        (4096, torch.float32, False), (4097, torch.float32, False),
        (6144, torch.bfloat16, False), (6145, torch.float16, False),
        (8192, torch.float32, False), (8193, torch.bfloat16, False),
        (12288, torch.float32, False), (12289, torch.float16, True),
        (16384, torch.bfloat16, False), (16385, torch.float32, False),
        (24576, torch.float16, False), (24577, torch.bfloat16, False),
        (32768, torch.float32, False), (32769, torch.bfloat16, True),
        (49152, torch.float16, False), (49153, torch.float32, False),
        (65536, torch.float32, False))) + (
    # the static program's trailing-axis norms (phase 7, form (c))
    (1024, 768, torch.float32, False),)


def check_layer_norm(device, rows=4096, f=768):
    from paddle_tpu_torch.kernels import layer_norm as LN
    worst = {}
    cases = [(rows, f, dtype, False, eps)
             for dtype in (torch.float32, torch.bfloat16)
             for eps in (1e-12, 1e-5)]
    cases += [(r, n, dt, w16, 1e-5) for r, n, dt, w16 in LN_EDGE_CASES]
    for rows, f, dtype, w16, eps in cases:
        x, gamma, beta = ln_inputs(rows, f, dtype, device, 7)
        if w16:
            gamma, beta = gamma.to(dtype), beta.to(dtype)
        y, mean, rstd = LN.layer_norm_fwd(x, gamma, beta, eps)
        torch.cuda.synchronize()
        ry, rmean, rrstd = LN.layer_norm_reference(x, gamma, beta, eps)
        tol = LN_TOL[dtype]
        parts = []
        for what, got, want in (("y", y, ry), ("mean", mean, rmean),
                                ("rstd", rstd, rrstd)):
            err, ok = max_err(got, want, *tol[what])
            parts.append(f"{what} {err:.3e} (tol {tol[what][0]:g} + "
                         f"{tol[what][1]:g}|ref|)")
            if not ok:
                fail(f"layer_norm {dtype} eps={eps} {what}: max error "
                     f"{err} beyond tolerance {tol[what]}")
            if what == "y":
                worst[(rows, f, dtype, eps)] = err
        say("parity", f"layer_norm [{rows}x{f}] {dtype} gamma "
            f"{gamma.dtype} eps={eps:g}: " + ", ".join(parts) + " ok")
    return worst


FLASH_CASES = (  # (b, h, sq, sk, d, padding bias, causal)
    (8, 12, 512, 512, 64, False, False),
    (8, 12, 512, 512, 64, True, False),
    (1, 12, 384, 384, 64, False, False),
    (1, 12, 384, 384, 64, True, False),
    (8, 12, 128, 128, 64, False, False),  # the static program's attention
)
FLASH_CAUSAL_CASE = (2, 12, 512, 384, 64, False, True)
# other code paths: D = 128, ragged tiles, q/k/v as strided views of one
# fused [B, S, 3E] projection (the main path's layout), and rows that do
# not start on 16 bytes (scalar loads)
FLASH_EDGE_CASES = (  # (b, h, sq, sk, d, bias, causal, dtype, layout)
    (2, 4, 200, 130, 128, True, False, torch.bfloat16, "contiguous"),
    (2, 4, 200, 130, 128, True, False, torch.float32, "contiguous"),
    (2, 12, 512, 384, 64, False, True, torch.bfloat16, "contiguous"),
    (2, 12, 77, 77, 64, True, False, torch.bfloat16, "qkv_views"),
    (2, 12, 77, 77, 64, True, False, torch.float32, "qkv_views"),
    (1, 4, 100, 100, 64, False, True, torch.bfloat16, "unaligned"),
    (1, 4, 100, 100, 128, False, True, torch.bfloat16, "unaligned"),
    # D 256 (every dtype x dropout x bias layout is in FLASH_INSTANCE_CASES)
    (2, 8, 512, 384, 256, False, True, torch.bfloat16, "contiguous"),
    (2, 8, 512, 384, 256, False, True, torch.float32, "contiguous"),
    (2, 8, 77, 77, 256, True, False, torch.bfloat16, "qkv_views"),
    (2, 8, 77, 77, 256, True, False, torch.float32, "qkv_views"),
    (1, 4, 100, 100, 256, False, True, torch.bfloat16, "unaligned"),
    (1, 4, 100, 100, 256, False, True, torch.float16, "unaligned"),
    # form (d)'s multihead_matmul (phase 11)
    (8, 12, 128, 128, 64, False, False, torch.bfloat16, "qkv_views"),
    (8, 12, 128, 128, 64, False, False, torch.float16, "qkv_views"),
)


def edge_inputs(b, h, s, d, dtype, device, layout, seed):
    g = torch.Generator().manual_seed(seed)
    if layout == "qkv_views":
        qkv = torch.randn(b, s, 3 * h * d, generator=g).to(dtype).to(device)
        return tuple(t.reshape(b, s, h, d).transpose(1, 2)
                     for t in qkv.split(h * d, dim=-1))
    base = torch.randn(3, b, h, s, d + 1, generator=g).to(dtype).to(device)
    return tuple(base[i, ..., 1:] for i in range(3))


def check_flash(device):
    from paddle_tpu_torch.kernels import flash_attention as FA
    worst = {}
    cases = [(*c, dt, "contiguous") for c in FLASH_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((*FLASH_CAUSAL_CASE, torch.float32, "contiguous"))
    cases += FLASH_EDGE_CASES
    for b, h, sq, sk, d, with_bias, causal, dtype, layout in cases:
        if layout == "contiguous":
            q, k, v = attn_inputs(b, h, sq, sk, d, dtype, device, 11)
        else:
            q, k, v = edge_inputs(b, h, sq, d, dtype, device, layout, 11)
        bias = padding_bias(b, sk, device, 12) if with_bias else None
        o, lse = FA.flash_attention_fwd(q, k, v, bias, causal)
        torch.cuda.synchronize()
        ro, rlse = FA.attention_reference(q, k, v, bias, causal)
        tol = FLASH_TOL[dtype]
        err_o, ok_o = max_err(o, ro, *tol["o"])
        err_l, ok_l = max_err(lse, rlse, *tol["lse"])
        label = (f"flash [{b},{h},{sq},{d}] sk={sk} {dtype} "
                 f"bias={'[B,1,1,S]' if with_bias else 'none'} "
                 f"causal={causal} {layout}")
        if not (ok_o and ok_l):
            fail(f"{label}: o error {err_o} (tol {tol['o']}), lse error "
                 f"{err_l} (tol {tol['lse']})")
        if causal and sq > sk:
            empty = sq - sk
            if o[:, :, :empty].abs().max().item() != 0.0 or \
                    lse[:, :, :empty].abs().max().item() != 0.0:
                fail(f"{label}: rows with no visible key must give o = 0 "
                     "and lse = 0")
        worst[(b, h, sq, sk, d, with_bias, causal, dtype, layout)] = err_o
        say("parity", f"{label}: o {err_o:.3e} (tol {tol['o'][0]:g} + "
            f"{tol['o'][1]:g}|ref|), lse {err_l:.3e} ok")
    return worst


def source_constants(names, *files):
    """{name: value} of ``constexpr int name = value;`` lines in the
    kernel sources (csrc/<file>)."""
    from paddle_tpu_torch.kernels import _build
    src = "".join((_build.CSRC_DIR / f).read_text() for f in files)
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1)) for name in names}


# every compiled instance of the forward, (D, dropout, bias) in each dtype,
# at a ragged shape with Sq > Sk (causal where there is no bias, so rows
# without a key and the masked tiles run): (b, h, sq, sk, d, bias, causal,
# dtype, dropout). Then rows whose every key the bias masks: "pad_empty"
# is the padding mask with the last batch row all padding, "full_empty" a
# full bias with every third query of batch 0 masked.
FLASH_INSTANCE_CASES = tuple(
    (2, 4, 200, 130, d, bias, bias is None, dtype, drop)
    for dtype in (torch.bfloat16, torch.float16, torch.float32)
    for d in (64, 128, 256)
    for drop in (None, "mask", "seed") for bias in (None, "pad", "full")) + \
    tuple((2, 4, 200, 130, 64, bias, False, dtype, drop)
          for dtype in (torch.bfloat16, torch.float16, torch.float32)
          for drop in (None, "seed") for bias in ("pad_empty", "full_empty"))


def masked_rows(bias, b, h, sq, sk):
    """[B,H,Sq] rows whose every key the bias puts below -1e30, the TPU
    kernel's starting max: _fwd_kernel keeps l = 0 there and writes o = 0
    and lse = 0, where attention_reference (like the JAX package's) gives
    the row a uniform softmax."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    if bias is None:
        return None
    return (bias.expand(b, h, sq, sk) < FA.NEG_INF).all(-1)


def check_flash_instances(device):
    """Each case of FLASH_INSTANCE_CASES through _launch_fwd against
    attention_reference with the keep mask the kernel used, within
    FLASH_TOL. Seed mode must equal mask mode with philox_keep_mask bit
    for bit, and for both dropout modes the two wrong dropouts of
    check_flash_bwd (the neighbouring key's bit, 1/keep_prob left out) must
    fail the tolerance. A row with no visible key, by causality or by the
    bias, must give o = 0 and lse = 0 exactly. Returns the largest o error
    per dtype."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    worst, wrong = {}, {}
    for i, (b, h, sq, sk, d, bias_kind, causal, dtype, drop) in \
            enumerate(FLASH_INSTANCE_CASES):
        q, k, v = attn_inputs(b, h, sq, sk, d, dtype, device, 70 + i)
        bias = None
        if bias_kind in ("pad", "pad_empty"):
            bias = padding_bias(b, sk, device, 80 + i, lo=sk // 2)
        elif bias_kind in ("full", "full_empty"):
            bias = full_bias(b, sq, sk, device, 80 + i)
        if bias_kind == "pad_empty":
            bias[-1] = torch.finfo(torch.float32).min
        elif bias_kind == "full_empty":
            bias[0, :, ::3] = torch.finfo(torch.float32).min
        empty = masked_rows(bias, b, h, sq, sk)
        keep, seed, seed_t = None, None, None
        kp = KEEP_PROB if drop else 1.0
        if drop == "mask":
            g = torch.Generator().manual_seed(90 + i)
            keep = (torch.rand(b, h, sq, sk, generator=g) < kp).to(device)
        elif drop == "seed":
            seed = 7000003 * (i + 1)
            seed_t = FA.seed_tensor(seed, device)
        scale = 1.0 / math.sqrt(d)
        o, lse = FA._launch_fwd(q, k, v, bias, causal, scale, keep, seed_t,
                                kp)
        plain_keep = keep if drop != "seed" else FA.philox_keep_mask(
            seed, b, h, sq, sk, kp, device=device)
        label = (f"flash fwd instance [{b},{h},{sq},{d}] sk={sk} "
                 f"{str(dtype)[6:]} bias={bias_kind} causal={causal} "
                 f"dropout={drop}")
        if drop == "seed":
            again = FA._launch_fwd(q, k, v, bias, causal, scale, plain_keep,
                                   None, kp)
            if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
                fail(f"{label}: seed mode and mask mode with "
                     "philox_keep_mask differ")
        torch.cuda.synchronize()
        ro, rlse = FA.attention_reference(q, k, v, bias, causal, scale,
                                          plain_keep, kp)
        if empty is not None:
            ro, rlse = ro.masked_fill(empty[..., None], 0.0), \
                rlse.masked_fill(empty, 0.0)
        tol = FLASH_TOL[dtype]
        err_o, ok_o = max_err(o, ro, *tol["o"])
        err_l, ok_l = max_err(lse, rlse, *tol["lse"])
        if not (ok_o and ok_l):
            fail(f"{label}: o error {err_o} (tol {tol['o']}), lse error "
                 f"{err_l} (tol {tol['lse']})")
        if causal and sq > sk and (o[:, :, :sq - sk].abs().max().item() != 0
                                   or lse[:, :, :sq - sk].abs().max().item()
                                   != 0):
            fail(f"{label}: rows with no visible key must give o = 0 and "
                 "lse = 0")
        parts = [f"o {err_o:.3e}, lse {err_l:.3e}"]
        if empty is not None and bool(empty.any()):
            if o[empty].abs().max().item() != 0 or \
                    lse[empty].abs().max().item() != 0:
                fail(f"{label}: rows whose every key the bias masks must "
                     "give o = 0 and lse = 0, as _fwd_kernel does")
            parts.append(f"{int(empty.sum())} rows masked by the bias give "
                         "o = 0, lse = 0")
        if drop:
            for bug, keep_, kp_ in (("neighbouring key",
                                     swapped_keys(plain_keep), kp),
                                    ("no 1/keep_prob", plain_keep, 1.0)):
                bad = FA.attention_reference(q, k, v, bias, causal, scale,
                                             keep_, kp_)[0]
                if empty is not None:
                    bad = bad.masked_fill(empty[..., None], 0.0)
                berr, bok = max_err(o, bad, *tol["o"])
                if bok:
                    fail(f"{label}: a dropout with the {bug} would pass "
                         f"(o error {berr}, tol {tol['o']})")
                wrong[dtype] = min(wrong.get(dtype, math.inf), berr)
                parts.append(f"{bug} {berr:.3e}")
        worst[dtype] = max(worst.get(dtype, 0.0), err_o)
        say("parity", f"{label}: " + ", ".join(parts) +
            ("; seed == mask mode bit for bit" if drop == "seed" else "") +
            f"; tol o {tol['o']}, lse {tol['lse']}; ok")
    for dtype in worst:
        say("parity", f"flash fwd instances {dtype}: sound kernels o error "
            f"<= {worst[dtype]:.3e}, wrong dropouts >= "
            f"{wrong.get(dtype, math.inf):.3e}; tol o {FLASH_TOL[dtype]['o']}")
    return worst


# ---------------------------------------------------------------------------
# phase 5 (i): kernel parity of the training path's kernels
# ---------------------------------------------------------------------------

# Tolerances of the backward kernels against their plain versions on the
# card. Layer norm, fp32: dx is O(1) values from the same fp32 arithmetic
# in another order (a few ulps); dgamma and dbeta sum 16384 rows of O(1)
# terms in another order (a warp's ~16 rows, 8 warps, then 132 groups),
# an error of ~1e-5 of their O(100) size. bf16 dx: both sides round nearly
# the same fp32 value to bf16, up to two bf16 steps apart.
LN_BWD_TOL = {torch.float32: dict(dx=(1e-5, 1e-5), dgamma=(1e-3, 1e-5),
                                  dbeta=(1e-3, 1e-5)),
              torch.bfloat16: dict(dx=(2.0 ** -9, 2.0 ** -6),
                                   dgamma=(1e-3, 1e-5), dbeta=(1e-3, 1e-5)),
              # fp16 dx as bf16's at fp16's step; fp16 dgamma and dbeta
              # (x and gamma fp16) round fp32 sums of up to ~5: two steps
              torch.float16: dict(dx=(2.0 ** -12, 2.0 ** -9),
                                  dgamma=(1e-3, 2.0 ** -9),
                                  dbeta=(1e-3, 2.0 ** -9))}
# Flash backward (and the forward's o with dropout), (A, R): an element
# passes when |got - want| <= A + R |want|, with A taken as a fraction of
# the output's max |ref| in bf16 and fp16. fp32: the same fp32 arithmetic in
# another order; dk and dv sum over 512 queries and dq over 512 keys,
# gradients of size ~1, so a few 1e-6. bf16: the kernels round p and ds to
# bf16 (2^-8 relative) before the tensor-core products and round the
# results to bf16; the plain version rounds once, at the end. The limit
# lies between what the sound kernels need and what a wrong dropout (the
# keep pattern of the neighbouring key, or 1/keep_prob left out) needs,
# both read by this script (check_flash_bwd; readings in PERF.md). fp16:
# the same roundings at fp16's step, three bits finer, so A and R are an
# eighth of bf16's.
FLASH_BWD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -8,
                                                               2.0 ** -6),
                 torch.float16: (2.0 ** -11, 2.0 ** -9)}
# the seed-mode drop rate over a [32, 12, 512, 512] pattern: 100M Bernoulli
# draws with p = 0.1 have a standard deviation of 3e-5, so 0.002 is ~60 sd
DROP_RATE_TOL = 0.002


def ln_bwd_case(rows, f, dtype, w16, device, seed):
    from paddle_tpu_torch.kernels import layer_norm as LN
    x, gamma, beta = ln_inputs(rows, f, dtype, device, seed)
    if w16:
        gamma, beta = gamma.to(dtype), beta.to(dtype)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn(rows, f, generator=g).to(dtype).to(device)
    _, mean, rstd = LN._launch(x, gamma, beta, 1e-12)
    return dy, x, gamma, mean, rstd


def check_layer_norm_bwd(device, rows=16384, f=768):
    from paddle_tpu_torch.kernels import layer_norm as LN
    worst = {}
    cases = [(rows, f, dtype, False) for dtype in (torch.float32,
                                                   torch.bfloat16)]
    cases += [(r, n, dt, w16) for r, n, dt, w16 in LN_EDGE_CASES]
    for rows_, f_, dtype, w16 in cases:
        dy, x, gamma, mean, rstd = ln_bwd_case(rows_, f_, dtype, w16, device,
                                               21)
        got = LN._launch_bwd(dy, x, gamma, mean, rstd)
        again = LN._launch_bwd(dy, x, gamma, mean, rstd)
        torch.cuda.synchronize()
        want = LN.layer_norm_backward_reference(dy, x, gamma, mean, rstd)
        tol = LN_BWD_TOL[dtype]
        parts = []
        for what, gt, wt in zip(("dx", "dgamma", "dbeta"), got, want):
            if gt.dtype != wt.dtype:
                fail(f"layer_norm_bwd {what}: dtype {gt.dtype}, want "
                     f"{wt.dtype}")
            err, ok = max_err(gt, wt, *tol[what])
            parts.append(f"{what} {err:.3e}")
            if not ok:
                fail(f"layer_norm_bwd [{rows_}x{f_}] {dtype} {what}: max "
                     f"error {err} beyond tolerance {tol[what]}")
            worst[(rows_, f_, dtype)] = max(worst.get((rows_, f_, dtype),
                                                      0.0), err)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"layer_norm_bwd [{rows_}x{f_}] {dtype}: two runs differ")
        say("parity", f"layer_norm_bwd [{rows_}x{f_}] {dtype} gamma "
            f"{gamma.dtype}: " + ", ".join(parts) + f" (tol {tol}); two "
            "runs bitwise equal; ok")
    return worst


def attn_grad_inputs(b, h, sq, sk, d, dtype, device, layout, seed):
    if layout == "contiguous":
        q, k, v = attn_inputs(b, h, sq, sk, d, dtype, device, seed)
    else:
        q, k, v = edge_inputs(b, h, sq, d, dtype, device, layout, seed)
    g = torch.Generator().manual_seed(seed + 7)
    do = torch.randn(b, h, sq, d, generator=g).to(dtype).to(device)
    return q, k, v, do


def full_bias(b, sq, sk, device, seed):
    """A [B, 1, Sq, Sk] additive bias: a stride along q, unlike the
    padding mask, so the dK/dV kernel's transposed reads see both."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, 1, sq, sk, generator=g).to(device)


# (b, h, sq, sk, d, bias, causal, dtype, layout, dropout): bias is None,
# "pad" ([B,1,1,S]) or "full" ([B,1,Sq,Sk]); dropout is None, "mask" or
# "seed"
FLASH_BWD_CASES = (
    (32, 12, 512, 512, 64, None, False, torch.bfloat16, "contiguous", None),
    (32, 12, 512, 512, 64, "pad", False, torch.bfloat16, "contiguous", None),
    (8, 12, 512, 512, 64, None, False, torch.float32, "contiguous", None),
    (8, 12, 512, 512, 64, "pad", False, torch.float32, "contiguous", None),
    (8, 12, 512, 512, 64, "pad", False, torch.float32, "contiguous", "mask"),
    (8, 12, 512, 512, 64, "pad", False, torch.bfloat16, "contiguous", "mask"),
    (8, 12, 512, 512, 64, "pad", False, torch.float32, "contiguous", "seed"),
    (32, 12, 512, 512, 64, None, False, torch.bfloat16, "contiguous", "seed"),
    (2, 12, 512, 384, 64, None, True, torch.float32, "contiguous", "seed"),
    (2, 12, 512, 384, 64, None, True, torch.bfloat16, "contiguous", None),
    (2, 4, 200, 130, 128, "full", False, torch.float32, "contiguous", "mask"),
    (2, 4, 200, 130, 128, "full", False, torch.bfloat16, "contiguous", None),
    (2, 12, 77, 77, 64, "pad", False, torch.bfloat16, "qkv_views", "seed"),
    (2, 12, 77, 77, 64, "full", False, torch.float32, "qkv_views", "seed"),
    (1, 4, 100, 100, 64, None, True, torch.bfloat16, "unaligned", "seed"),
    (1, 4, 100, 100, 128, None, True, torch.bfloat16, "unaligned", None),
    # the rest of the bf16 kernels' instances (D x dropout x full bias)
    (2, 4, 200, 130, 64, "full", False, torch.bfloat16, "contiguous", None),
    (2, 12, 77, 77, 64, "full", True, torch.bfloat16, "contiguous", "mask"),
    (2, 12, 77, 77, 64, "full", False, torch.bfloat16, "qkv_views", "seed"),
    (2, 4, 200, 130, 128, None, False, torch.bfloat16, "contiguous", "seed"),
    (2, 4, 200, 130, 128, "pad", True, torch.bfloat16, "contiguous", "mask"),
    (2, 4, 200, 130, 128, "full", False, torch.bfloat16, "contiguous",
     "mask"),
    (2, 4, 200, 130, 128, "full", True, torch.bfloat16, "contiguous", "seed"),
) + tuple(  # every fp16 and fp32 instance and the bf16 ones at D 256
    (2, 4, 200, 130, d, bias, bias == "pad", dtype, "contiguous", drop)
    for dtype, dims in ((torch.float16, (64, 128, 256)),
                        (torch.float32, (64, 128, 256)),
                        (torch.bfloat16, (256,)))
    for d in dims for drop in (None, "mask", "seed")
    for bias in ("pad", "full")) + (
    (1, 4, 100, 100, 64, None, True, torch.float16, "unaligned", "seed"),
    # D 256: causal with Sq > Sk, the fused projection's views, and
    # misaligned inputs
    (2, 4, 200, 130, 256, None, True, torch.bfloat16, "contiguous", "seed"),
    (2, 4, 200, 130, 256, None, True, torch.float32, "contiguous", None),
    (2, 4, 77, 77, 256, "pad", False, torch.bfloat16, "qkv_views", "seed"),
    (2, 4, 77, 77, 256, "full", False, torch.float32, "qkv_views", "mask"),
    (1, 4, 100, 100, 256, None, True, torch.bfloat16, "unaligned", None),
    (1, 4, 100, 100, 256, None, True, torch.float16, "unaligned", "seed"),
    # the fp16 recipe's calls (phase 6): the train shape, seed dropout 0.1
    (32, 12, 512, 512, 64, None, False, torch.float16, "contiguous", None),
    (32, 12, 512, 512, 64, None, False, torch.float16, "contiguous", "seed"),
    # the static program's multihead_matmul (phase 7, forms (b) and (c))
    (8, 12, 128, 128, 64, None, False, torch.float32, "qkv_views", None),
    # form (d)'s (phase 11): bf16 and fp16 on the packed projection's views
    (8, 12, 128, 128, 64, None, False, torch.bfloat16, "qkv_views", None),
    (8, 12, 128, 128, 64, None, False, torch.float16, "qkv_views", None))
KEEP_PROB = 0.9


def needed_atol(got, want, rtol, scale):
    """The least A with |got - want| <= A scale + rtol |want| everywhere:
    how much of the absolute allowance a comparison uses."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - rtol * w.abs()).max().clamp_min(0.0)) / \
        scale


def swapped_keys(keep):
    """The keep pattern with keys 2j and 2j + 1 swapped: what a kernel
    that took the neighbouring key's Philox word would use."""
    sk = keep.shape[-1]
    idx = (torch.arange(sk, device=keep.device) ^ 1).clamp(max=sk - 1)
    return keep[..., idx]


def flash_bwd_need(outs, dtype):
    """The largest needed_atol over (what, got, want) triples, with the
    scale FLASH_BWD_TOL[dtype] uses."""
    rtol = FLASH_BWD_TOL[dtype][1]
    need = {}
    for what, got, want in outs:
        scale = float(want.float().abs().max()) \
            if dtype != torch.float32 else 1.0
        need[what] = needed_atol(got, want, rtol, scale)
    return need


def check_flash_bwd(device):
    """The forward (with dropout) and the dQ and dK/dV kernels against the
    plain versions on the same inputs: the plain backward gets the
    kernel's o and lse, and the keep mask the kernels used (the explicit
    one, or philox_keep_mask of the seed). A seed-mode case runs the
    kernels again in mask mode with philox_keep_mask, and the two must be
    bitwise equal: that holds the word selection of every kernel to the
    plain pattern. A dropout case also computes what two wrong dropouts
    would give and fails if the tolerance would pass them."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    worst, sound, wrong = {}, {}, {}
    for i, (b, h, sq, sk, d, bias_kind, causal, dtype, layout, drop) in \
            enumerate(FLASH_BWD_CASES):
        q, k, v, do = attn_grad_inputs(b, h, sq, sk, d, dtype, device,
                                       layout, 40 + i)
        bias = None
        if bias_kind == "pad":
            bias = padding_bias(b, sk, device, 50 + i)
        elif bias_kind == "full":
            bias = full_bias(b, sq, sk, device, 50 + i)
        keep, seed, seed_t = None, None, None
        if drop == "mask":
            g = torch.Generator().manual_seed(60 + i)
            keep = (torch.rand(b, h, sq, sk, generator=g) < KEEP_PROB
                    ).to(device)
        elif drop == "seed":
            seed = 1000003 * (i + 1)
            seed_t = FA.seed_tensor(seed, device)
        kp = KEEP_PROB if drop else 1.0
        scale = 1.0 / math.sqrt(d)
        o, lse = FA._launch_fwd(q, k, v, bias, causal, scale, keep, seed_t,
                                kp)
        copies = FA.bwd_copies
        dq, dk, dv = FA._launch_bwd(do, q, k, v, o, lse, bias, causal, scale,
                                    keep, seed_t, kp)
        torch.cuda.synchronize()
        copies = FA.bwd_copies - copies
        plain_keep = keep if drop != "seed" else FA.philox_keep_mask(
            seed, b, h, sq, sk, kp, device=device)
        label = (f"flash bwd [{b},{h},{sq},{d}] sk={sk} {dtype} bias="
                 f"{bias_kind} causal={causal} {layout} dropout={drop}")
        # the tensor-core kernels read 16-byte chunks: only the misaligned
        # q, k, v views are copied first, the fused projection's views are
        # not
        want = 3 if layout == "unaligned" and dtype != torch.float32 else 0
        if copies != want:
            fail(f"{label}: {copies} inputs copied before the launch, want "
                 f"{want}")
        if drop == "seed" and b == TRAIN_B and dtype != torch.float32:
            # no atomics: a second run gives the same bits
            again = FA._launch_bwd(do, q, k, v, o, lse, bias, causal, scale,
                                   None, seed_t, kp)
            for what, a, b_ in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
                if not torch.equal(a, b_):
                    fail(f"{label}: a second run differs in {what}")
            say("parity", f"{label}: a second run gives dq, dk and dv bit "
                "for bit")
            del again
        if drop == "seed":
            o2, lse2 = FA._launch_fwd(q, k, v, bias, causal, scale,
                                      plain_keep, None, kp)
            again = (o2, lse2) + FA._launch_bwd(do, q, k, v, o2, lse2, bias,
                                                causal, scale, plain_keep,
                                                None, kp)
            for what, a, b_ in zip(("o", "lse", "dq", "dk", "dv"),
                                   (o, lse, dq, dk, dv), again):
                if not torch.equal(a, b_):
                    fail(f"{label}: seed mode and mask mode with "
                         f"philox_keep_mask differ in {what}")
            del o2, lse2, again

        def plain(keep_, kp_):
            """(o, dq, dk, dv, lse) of the plain versions"""
            ro, rlse_ = FA.attention_reference(q, k, v, bias, causal, scale,
                                               keep_, kp_)
            return (ro,) + FA.attention_backward_reference(
                do, q, k, v, o, lse, bias, causal, scale, keep_, kp_) + \
                (rlse_,)
        want = plain(plain_keep, kp)
        rlse = want[4]
        err_l, ok_l = max_err(lse, rlse, *FLASH_TOL[dtype]["lse"])
        if not ok_l:
            fail(f"{label}: forward lse error {err_l}")
        atol_a, rtol = FLASH_BWD_TOL[dtype]
        # o too: in bf16 a causal row with few visible keys has p near 1,
        # rounded to bf16 before p v, so its o may be a few bf16 steps off
        outs = list(zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want))
        need = flash_bwd_need(outs, dtype)
        parts = []
        for what, got, ref in outs:
            err = float((got.float() - ref.float()).abs().max())
            parts.append(f"{what} {err:.3e} (A {need[what]:.2e})")
            if need[what] > atol_a or got.dtype != ref.dtype:
                fail(f"{label}: {what} max error {err} needs A "
                     f"{need[what]} > {atol_a} (R {rtol}; dtype "
                     f"{got.dtype})")
            worst[(i, what)] = err
        sound[dtype] = max(sound.get(dtype, 0.0), max(need.values()))
        if drop:
            for bug, keep_, kp_ in (("neighbouring key", swapped_keys(
                    plain_keep), kp), ("no 1/keep_prob", plain_keep, 1.0)):
                bad = plain(keep_, kp_)[:4]
                bneed = max(flash_bwd_need(
                    [(w, g_, r_) for (w, g_, _), r_ in zip(outs, bad)],
                    dtype).values())
                if bneed <= atol_a:
                    fail(f"{label}: a dropout with the {bug} would pass "
                         f"(needs A {bneed} <= {atol_a})")
                wrong[dtype] = min(wrong.get(dtype, math.inf), bneed)
                parts.append(f"{bug}: A {bneed:.2e}")
                del bad
        say("parity", f"{label}: " + ", ".join(parts) +
            f"; lse {err_l:.3e}; tol (A, R) {FLASH_BWD_TOL[dtype]}; ok")
    for dtype in sound:
        say("parity", f"flash bwd {dtype}: the sound kernels need A <= "
            f"{sound[dtype]:.3e}, the wrong dropouts A >= "
            f"{wrong.get(dtype, math.inf):.3e}; limit A "
            f"{FLASH_BWD_TOL[dtype][0]:g}, R {FLASH_BWD_TOL[dtype][1]:g}")
    return worst


def check_dropout_pattern(device):
    """The seed-mode pattern as kernel_keep_mask generates it (Philox
    and the word selection of the bf16 forward and dQ kernels) against
    philox_keep_mask on the card, bit for bit, and its drop rate over the
    main path's [32, 12, 512, 512]."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    rate = None
    for shape in ((32, 12, 512, 512), (3, 2, 77, 45)):
        seed = 0x5EED0000 + shape[2]
        got = FA.kernel_keep_mask(FA.seed_tensor(seed, device), *shape,
                                  KEEP_PROB)
        want = FA.philox_keep_mask(seed, *shape, KEEP_PROB, device=device)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"dropout pattern {shape}: kernel and philox_keep_mask "
                 f"differ in {int((got != want).sum())} elements")
        drop = 1.0 - float(got.float().mean())
        if shape[0] == 32:
            rate = drop
            if abs(drop - (1.0 - KEEP_PROB)) > DROP_RATE_TOL:
                fail(f"seed-mode drop rate {drop} is not within "
                     f"{1.0 - KEEP_PROB} +- {DROP_RATE_TOL}")
        say("parity", f"dropout pattern {list(shape)} seed {seed:#x}: "
            f"kernel == philox_keep_mask bit for bit, drop rate {drop:.5f}")
    del got, want
    return rate


# ---------------------------------------------------------------------------
# routes: the path each shape and dtype takes on the card
# ---------------------------------------------------------------------------

# the routed cases against the CPU port, both fp32 (the card's matmuls in
# full fp32, TF32 off) summed in other orders: each tensor held to 1e-4 of
# its own largest element plus 1e-4 relative, the rule of the port's CPU
# tests for gradients
ROUTE_TOL = 1e-4
# an fp16 forward of a 2-layer BERT against the fp32 CPU port: fp16 rounds
# every product's inputs at 2^-11, some ten roundings deep, and cuBLAS may
# reduce fp16 products in fp16; 1% of the largest logit
FP16_TOL = 1e-2
# a bf16 auto_cast forward of MultiHeadAttention against the fp32 CPU port:
# the same rule at bf16's step, 2^-8 against fp16's 2^-11
BF16_TOL = 8 * FP16_TOL


def close_to(got, want, rel):
    """max_err with atol = rel max|want| and rtol = rel, on the CPU."""
    w = want.detach().float().cpu()
    return max_err(got.detach().cpu(), w, rel * float(w.abs().max()), rel)


def route_mha(device, embed, heads, dropout, seed):
    """MultiHeadAttention(embed, heads) on the card and on the CPU from one
    state, in training with a padding mask, forward and backward from one
    port seed. Returns ((out, grads) on the card, on the CPU, the card's
    path log)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.jit import load_reference_state
    from paddle_tpu_torch.nn import MultiHeadAttention
    from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                                 reset_attention_path_log)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 96, embed), dtype=np.float32)
    w = rng.standard_normal((2, 96, embed), dtype=np.float32)
    mask = np.zeros((2, 1, 1, 96), np.float32)
    mask[1, ..., 60:] = np.finfo(np.float32).min
    results, logs = [], []
    for dev in (device, torch.device("cpu")):
        layer = MultiHeadAttention(embed, heads, dropout, device=dev)
        if not results:
            state = random_state(layer, seed)
        load_reference_state(layer, state)
        layer.train()
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        paddle_tpu_torch.seed(seed)
        reset_attention_path_log()
        out = layer(xt, attn_mask=torch.from_numpy(mask).to(dev))
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        logs.append(attention_paths_taken())
        grads = {n: p.grad for n, p in layer.named_parameters()}
        grads["input"] = xt.grad
        results.append((out, grads))
    if logs[1] != ["reference"]:
        fail(f"routes: the CPU port's attention path log is {logs[1]}")
    return results[0], results[1], logs[0]


def flash_counts():
    from paddle_tpu_torch.kernels import flash_attention as FA
    return (FA.launches, FA.launches_dq, FA.launches_dkv)


def check_routes(device):
    """The port's routes through its entry points on the card, each with
    its path log read back: head dim 32 (MultiHeadAttention(256, 8), which
    the JAX router composes) and head dim 256 (MultiHeadAttention(512, 2),
    on the flash kernels: one forward, dQ and dK/dV launch) in fp32 with
    and without seed dropout, forward and every gradient against the CPU
    port; head dim 256 forward under bf16 auto_cast against the fp32 CPU
    port; a 2-layer BERT forward under auto_cast(dtype="float16") on the
    fp16 flash and layer-norm instances against the fp32 CPU port; layer
    norms over 8192 features and in fp16, one kernel launch each way,
    against the CPU port."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import load_reference_state
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn import MultiHeadAttention
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                                 reset_attention_path_log)
    for embed, heads, dropout in ((256, 8, 0.0), (256, 8, 0.1),
                                  (512, 2, 0.0), (512, 2, 0.1)):
        route = "composed" if embed // heads == 32 else "flash"
        before = flash_counts()
        (out, grads), (out_c, grads_c), log = route_mha(
            device, embed, heads, dropout, 40 + embed + heads)
        n = tuple(a - b for a, b in zip(flash_counts(), before))
        what = (f"MultiHeadAttention({embed}, {heads}) head dim "
                f"{embed // heads} dropout {dropout:g}")
        want_n = (1, 1, 1) if route == "flash" else (0, 0, 0)
        if log != [route] or n != want_n:
            fail(f"routes: {what}: path log {log}, flash launches (fwd, "
                 f"dq, dkv) {n}; want [{route!r}], {want_n}")
        # the key bias's gradient is 0 in exact arithmetic (it shifts a
        # row's scores by one constant): both sides hold rounding noise
        errs = {"out": close_to(out, out_c, ROUTE_TOL)}
        errs.update({n: close_to(g, grads_c[n], ROUTE_TOL)
                     for n, g in grads.items() if n != "k_proj.bias"})
        bad = [n for n, (_, ok) in errs.items() if not ok]
        if bad:
            fail(f"routes: {what}: {bad} beyond {ROUTE_TOL:g} of the CPU "
                 f"port: {[errs[n][0] for n in bad]}")
        say("routes", f"{what}: path log [{route!r}] (CPU port "
            f"['reference']), flash launches (fwd, dq, dkv) {n}; output and "
            f"{len(errs) - 1} gradients against "
            f"the CPU port, max error {max(e for e, _ in errs.values()):.3e}"
            f" (tol {ROUTE_TOL:g} of each tensor's largest + {ROUTE_TOL:g}"
            "|ref|); ok")

    # head dim 256 under bf16 auto_cast: the bf16 D 256 flash instance
    mhas = [MultiHeadAttention(512, 2, device=d) for d in (device, "cpu")]
    state = random_state(mhas[0], SEED + 4)
    x = np.random.default_rng(SEED + 4).standard_normal((2, 96, 512),
                                                         dtype=np.float32)
    for m in mhas:
        load_reference_state(m, state)
        m.eval()
    before = flash_counts()
    reset_attention_path_log()
    with torch.no_grad(), amp.auto_cast():
        out = mhas[0](torch.from_numpy(x).to(device))
    n = tuple(a - b for a, b in zip(flash_counts(), before))
    log = attention_paths_taken()
    with torch.no_grad():
        out_c = mhas[1](torch.from_numpy(x))
    err, ok = close_to(out, out_c, BF16_TOL)
    what = "MultiHeadAttention(512, 2) head dim 256 auto_cast bf16 forward"
    if log != ["flash"] or n != (1, 0, 0) or not ok or \
            not torch.isfinite(out).all():
        fail(f"routes: {what}: path log {log}, launches {n}, output "
             f"{out.dtype} error {err} against the fp32 CPU port (tol "
             f"{BF16_TOL:g})")
    say("routes", f"{what}: path log ['flash'], one forward launch, output "
        f"{str(out.dtype)[6:]} max error {err:.3e} against the fp32 CPU port "
        f"(tol {BF16_TOL:g} of the largest + {BF16_TOL:g}|ref|); ok")
    del mhas

    # a small BERT under fp16 auto_cast: every attention on the fp16
    # flash instance
    cfg = BertConfig(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=512)
    models = [BertForPretraining(cfg, device=d) for d in (device, "cpu")]
    state = random_state(models[0], SEED + 5)
    for m in models:
        load_reference_state(m, state)
        m.eval()
    req = make_request(4, 128, True, cfg.vocab_size, device,
                       np.random.default_rng(SEED + 6))
    reset_attention_path_log()
    F.reset_layer_norm_path_log()
    launched = FA.launches
    with torch.no_grad(), amp.auto_cast(dtype="float16"):
        mlm, nsp = models[0](**req)
    n_flash = FA.launches - launched
    paths, ln_paths = attention_paths_taken(), F.layer_norm_paths_taken()
    with torch.no_grad():
        mlm_c, nsp_c = models[1](**{k: v.cpu() for k, v in req.items()})
    if paths != ["flash"] * cfg.num_hidden_layers or \
            n_flash != cfg.num_hidden_layers:
        fail(f"routes: fp16 BERT attention path log {paths}, {n_flash} "
             "flash launches")
    for what, g, c in (("mlm", mlm, mlm_c), ("nsp", nsp, nsp_c)):
        err, ok = close_to(g, c, FP16_TOL)
        if not ok or not torch.isfinite(g).all():
            fail(f"routes: fp16 BERT {what} logits against the fp32 CPU "
                 f"port: {err} beyond {FP16_TOL:g}")
        say("routes", f"BERT 2 layers, hidden 128, head dim 64, B=4 S=128 "
            f"padded, auto_cast(dtype='float16'), {what} logits "
            f"{str(g.dtype)[6:]}: max error {err:.3e} against the fp32 CPU "
            f"port (tol {FP16_TOL:g} of the largest + {FP16_TOL:g}|ref|); "
            f"attention path log {len(paths)} x 'flash' ({n_flash} "
            f"launches), layer-norm path log {sorted(set(ln_paths))} x "
            f"{len(ln_paths)}; ok")
    del models

    # layer norms on the wide-row and fp16 instances
    for rows, f, dtype in ((64, 8192, torch.float32),
                           (64, 768, torch.float16)):
        x, gamma, beta = ln_inputs(rows, f, torch.float32, "cpu", 60 + f)
        dy = torch.from_numpy(np.random.default_rng(61 + f).standard_normal(
            (rows, f), dtype=np.float32))
        outs = []
        for dev in (device, torch.device("cpu")):
            xt = x.to(dev, dtype).requires_grad_(True)
            gt, bt = (t.to(dev).requires_grad_(True) for t in (gamma, beta))
            F.reset_layer_norm_path_log()
            launched = (LN.launches, LN.launches_bwd)
            y = F.layer_norm(xt, f, gt, bt, 1e-5)
            y.backward(dy.to(dev, dtype))
            outs.append((y, xt.grad, gt.grad, bt.grad,
                         F.layer_norm_paths_taken(),
                         (LN.launches - launched[0],
                          LN.launches_bwd - launched[1])))
        (y, dx, dg, db, log, n), (y_c, dx_c, dg_c, db_c, _, _) = outs
        what = f"layer_norm [{rows}, {f}] {str(dtype)[6:]}"
        if log != ["kernel"] or n != (1, 1):
            fail(f"routes: {what}: path log {log}, {n} kernel launches "
                 "(forward, backward)")
        # fp32: ROUTE_TOL; fp16: both sides round one fp32 value to fp16
        rel = ROUTE_TOL if dtype == torch.float32 else 2.0 ** -10
        errs = {k: close_to(a, b, rel) for k, a, b in (
            ("y", y, y_c), ("dx", dx, dx_c), ("dgamma", dg, dg_c),
            ("dbeta", db, db_c))}
        bad = [k for k, (_, ok) in errs.items() if not ok]
        if bad:
            fail(f"routes: {what}: {bad} beyond {rel:g}: "
                 f"{[errs[k][0] for k in bad]}")
        say("routes", f"{what}: path log ['kernel'], one launch forward "
            "and one backward; y, dx, dgamma, dbeta against the CPU port, "
            f"max error {max(e for e, _ in errs.values()):.3e} (tol {rel:g}"
            f" of each tensor's largest + {rel:g}|ref|); ok")


# ---------------------------------------------------------------------------
# phase 3: serving, the main path
# ---------------------------------------------------------------------------

def answer(model, req, bf16):
    from paddle_tpu_torch import amp
    with torch.no_grad(), amp.auto_cast(enable=bf16):
        return model(**req)


def serve(model, requests):
    """Answer every request in fp32 and under bf16 auto_cast. Returns the
    outputs and, per forward, the launches each kernel made."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    outputs, per_forward = {}, {}
    for name, req in requests.items():
        for bf16 in (False, True):
            ln0, fa0 = LN.launches, FA.launches
            mlm, nsp = answer(model, req, bf16)
            torch.cuda.synchronize()
            per_forward[(name, bf16)] = (LN.launches - ln0,
                                         FA.launches - fa0)
            outputs[(name, bf16)] = (mlm, nsp)
    return outputs, per_forward


def check_outputs(outputs, requests, vocab):
    for (name, bf16), (mlm, nsp) in outputs.items():
        req = requests[name]
        b, s = req["input_ids"].shape
        m = req["masked_positions"].shape[1] \
            if "masked_positions" in req else s
        if tuple(mlm.shape) != (b, m, vocab) or tuple(nsp.shape) != (b, 2):
            fail(f"{name}: output shapes {tuple(mlm.shape)}, "
                 f"{tuple(nsp.shape)}")
        if not (torch.isfinite(mlm).all() and torch.isfinite(nsp).all()):
            fail(f"{name} bf16={bf16}: non-finite logits")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

# (rows, F, x dtype) timed: BERT-base's norm in each dtype, and a wide row
LN_TIME_CASES = ((4096, 768, torch.float32), (4096, 768, torch.bfloat16),
                 (4096, 768, torch.float16), (1024, 8192, torch.float32),
                 (1024, 768, torch.float32))  # the static program's norm


def time_layer_norm(device, card, eps=1e-12):
    from paddle_tpu_torch.kernels import layer_norm as LN
    records = {}
    for rows, f, dtype in LN_TIME_CASES:
        per = rows * f * (4 if dtype == torch.float32 else 2)
        sets = copies(lambda i: ln_inputs(rows, f, dtype, device, 100 + i),
                      per)
        kern = [lambda s=s: LN.layer_norm_fwd(*s, eps) for s in sets]
        plain = [lambda s=s: LN.layer_norm_reference(*s, eps) for s in sets]
        lib = [lambda s=s: torch.nn.functional.layer_norm(
            s[0], (f,), s[1].to(dtype), s[2].to(dtype), eps) for s in sets]
        ms, plain_ms, lib_ms = (device_ms(fns) for fns in (kern, plain, lib))
        nbytes, flops = ln_work(sets[0][0], sets[0][1])
        bms, by = bound_ms(nbytes, flops, dtype)
        records[(rows, f, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, bound_ms=bms,
                                         bound_by=by)
        say("times", f"layer_norm [{rows}x{f}] {dtype}: kernel {ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), plain {plain_ms:.4f} ms, "
            f"F.layer_norm {lib_ms:.4f} ms  [{card}]")
    return records


def causal_mask(sq, sk, device):
    """Boolean [Sq, Sk] mask, True where query i sees key j: the kernels'
    causal rule, aligned bottom-right (i + sk - sq >= j)."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
        diagonal=sk - sq)


# head dim 256, timed in each dtype: S = 1024 is the shortest length at
# which the JAX router sends a dropout-free D 256 attention to its kernel
# (paddle_tpu/nn/transformer.py _FLASH_MIN_SEQ), and 8 query heads of 256
# (hidden 2048) are Gemma-2B's attention width
D256_SHAPE = (4, 8, 1024, 256)


def time_flash(device, card):
    """The forward at FLASH_CASES in both dtypes, and at the train shape in
    bf16 with and without seed dropout: kernel, bound, plain version and
    SDPA."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    records = {}
    tiles = source_constants(("kFwdWarpgroups", "kFwdStages"),
                             "flash_attention.cu")
    say("times", f"flash forward tiling: bf16 {tiles['kFwdWarpgroups']} "
        f"warpgroup(s) a CTA, {64 * tiles['kFwdWarpgroups']} queries, "
        f"{tiles['kFwdStages']} stages of 64-key tiles; fp32 64 queries a "
        "CTA, 2 stages (D 256: 8 warps, one K and one V stage)")
    for (b, h, sq, sk, d, with_bias, causal) in FLASH_CASES + (
            FLASH_CAUSAL_CASE,):
        for dtype in (torch.float32, torch.bfloat16):
            esz = 4 if dtype == torch.float32 else 2
            per = (b * h * (sq + 2 * sk) * d) * esz

            def make(i):
                q, k, v = attn_inputs(b, h, sq, sk, d, dtype, device, 200 + i)
                bias = padding_bias(b, sk, device, 300 + i) \
                    if with_bias else None
                return q, k, v, bias
            sets = copies(make, per)
            kern = [lambda s=s: FA.flash_attention_fwd(*s, causal)
                    for s in sets]
            plain = [lambda s=s: FA.attention_reference(*s, causal)
                     for s in sets]
            ms, plain_ms = device_ms(kern), device_ms(plain)
            # SDPA's is_causal aligns top-left; the kernels' causal mask is
            # aligned bottom-right, so SDPA gets it as a boolean mask
            masks = [causal_mask(sq, sk, device) if causal else
                     None if s[3] is None else s[3] > -1.0 for s in sets]
            lib = [lambda s=s, m=m: torch.nn.functional
                   .scaled_dot_product_attention(
                       s[0], s[1], s[2], attn_mask=m,
                       scale=1.0 / math.sqrt(d))
                   for s, m in zip(sets, masks)]
            lib_ms = device_ms(lib)
            nbytes, flops = attn_work(sets[0][0], sets[0][1], sets[0][3],
                                      causal)
            bms, by = bound_ms(nbytes, flops, dtype)
            key = (b, h, sq, sk, d, with_bias, causal, dtype)
            records[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bms, bound_by=by)
            say("times", f"flash fwd {str(dtype)[6:]} [{b},{h},{sq},{d}] "
                f"sk={sk} bias={'[B,1,1,S]' if with_bias else 'none'} "
                f"causal={causal}: kernel {ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}), plain {plain_ms:.4f} ms, SDPA "
                f"{lib_ms:.4f} ms  [{card}]")

    # head dim 256 in each dtype, non-causal
    b, h, s, d = D256_SHAPE
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        sets = copies(lambda i: attn_inputs(b, h, s, s, d, dtype, device,
                                            600 + i),
                      3 * b * h * s * d * (4 if dtype == torch.float32
                                           else 2))
        ms = device_ms([lambda x=x: FA.flash_attention_fwd(*x) for x in sets])
        plain_ms = device_ms([lambda: FA.attention_reference(*sets[0])],
                             reps=3)
        lib_ms = device_ms([lambda x=x: torch.nn.functional
                            .scaled_dot_product_attention(
                                *x, scale=1.0 / math.sqrt(d)) for x in sets])
        nbytes, flops = attn_work(sets[0][0], sets[0][1], None, False)
        bms, by = bound_ms(nbytes, flops, dtype)
        records[("d256", dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=bms,
                                        bound_by=by)
        say("times", f"flash fwd {str(dtype)[6:]} [{b},{h},{s},{d}]: kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s), bound {bms:.4f} "
            f"ms ({by}), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms  "
            f"[{card}]")
        del sets

    # the train shape in bf16, without and with the main path's seed
    # dropout; SDPA with dropout_p draws random numbers, which a CUDA graph
    # cannot hold, so it is timed by the profiler
    b, h, s, d = TRAIN_B, 12, TRAIN_S, 64
    scale = 1.0 / math.sqrt(d)
    seed_t = FA.seed_tensor(77, device)
    for dtype, kp in ((torch.bfloat16, 1.0), (torch.bfloat16, KEEP_PROB),
                      (torch.float16, 1.0)):
        sets = copies(lambda i: attn_inputs(b, h, s, s, d, dtype, device,
                                            510 + i),
                      3 * b * h * s * d * 2)
        st = seed_t if kp < 1.0 else None
        ms = device_ms([lambda x=x: FA._launch_fwd(*x, None, False, scale,
                                                   None, st, kp)
                        for x in sets])

        def plain(x=sets[0]):
            keep = None if kp == 1.0 else FA.philox_keep_mask(
                77, b, h, s, s, kp, device)
            return FA.attention_reference(*x, None, False, scale, keep, kp)
        plain_ms = device_ms([plain], reps=2)
        if kp == 1.0:
            lib_ms = device_ms([lambda x=x: torch.nn.functional
                                .scaled_dot_product_attention(*x, scale=scale)
                                for x in sets])
        else:
            lib_ms = profiled_ms(lambda: torch.nn.functional
                                 .scaled_dot_product_attention(
                                     *sets[0], dropout_p=1.0 - kp,
                                     scale=scale))
        nbytes, flops = attn_work(sets[0][0], sets[0][1], None, False)
        bms, by = bound_ms(nbytes, flops, dtype)
        records[("train", dtype, kp)] = dict(ms=ms, plain_ms=plain_ms,
                                             library_ms=lib_ms, bound_ms=bms,
                                             bound_by=by)
        drop = "no dropout" if kp == 1.0 else \
            f"seed dropout {1.0 - kp:g}"
        lib = "SDPA" + ("" if kp == 1.0 else f" dropout_p={1.0 - kp:g}")
        say("times", f"flash fwd {str(dtype)[6:]} [{b},{h},{s},{d}] "
            f"(train shape) "
            f"{drop}: kernel {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s), "
            f"bound {bms:.4f} ms ({by}), plain {plain_ms:.4f} ms "
            f"(attention_reference{'' if kp == 1.0 else ' + philox_keep_mask'}"
            f"), {lib} {lib_ms:.4f} ms  [{card}]")
    return records


def time_forward(model, requests, card, reps=20):
    for name, req in requests.items():
        b, s = req["input_ids"].shape
        valid = int(req["attention_mask"].sum()) \
            if "attention_mask" in req else b * s
        for bf16 in (False, True):
            answer(model, req, bf16)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                answer(model, req, bf16)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            ms = 1e3 * float(np.median(times))
            # the same forward replayed from a CUDA graph: device time alone
            dev_ms = device_ms([lambda: answer(model, req, bf16)], reps=3)
            say("times", f"forward {name} {'bf16' if bf16 else 'fp32'}: "
                f"{ms:.3f} ms median of {reps}, {b * s / ms * 1e3:.0f} "
                f"tokens/s ({valid / ms * 1e3:.0f} non-padding tokens/s); "
                f"device {dev_ms:.3f} ms from a CUDA graph, idle share "
                f"{max(0.0, 1.0 - dev_ms / ms):.2f}  [{card}]")


KERNEL_GROUPS = (("flash attention", ("flash_fwd",)),
                 ("layer norm", ("layer_norm_fwd",)),
                 ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
                 ("casts and copies", ("copy",)))


def profile_forward(model, requests, card, names=("b8_s512_padded",
                                                   "b1_s77")):
    """Device time of one forward by kernel group, from torch.profiler's
    trace of the kernels (CUPTI). The profiler's own start-up lands in the
    host clock, so the forward's wall time is time_forward's business."""
    from torch.profiler import ProfilerActivity, profile
    for name in names:
        for bf16 in (False, True):
            answer(model, requests[name], bf16)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                answer(model, requests[name], bf16)
                torch.cuda.synchronize()
            groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
            groups["other elementwise"] = 0.0
            n_kernels = 0
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                n_kernels += 1
                group = next((g for g, keys in KERNEL_GROUPS
                              if any(k in e.name for k in keys)),
                             "other elementwise")
                groups[group] += e.time_range.elapsed_us() / 1e3
            busy = sum(groups.values())
            parts = ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.0%})"
                              for g, ms in groups.items())
            say("profile", f"forward {name} {'bf16' if bf16 else 'fp32'}: "
                f"{n_kernels} kernels, device busy {busy:.3f} ms: {parts}"
                f"  [{card}]")


# ---------------------------------------------------------------------------
# phase 5 (ii)-(iv): training
# ---------------------------------------------------------------------------

# the JAX package's training bench (bench.py _bench_bert): BERT-base with
# dropout on, B=32, S=512, 80 masked positions a row, Adam(1e-4), bf16
TRAIN_B, TRAIN_S, TRAIN_M, TRAIN_LR = 32, 512, 80, 1e-4
TRAIN_STEPS = 10
# (ii) fp32 step on the card against the CPU port, BERT-base, dropout 0.
# Loss: one fp32 scalar of ~10 through 12 layers summed in other orders.
# Gradients: each tensor within 1e-4 of its largest element plus 1e-4
# relative (fp32 through 12 layers in other orders: ~3e-6 measured), with
# a floor of 1e-5 of the model's largest gradient for the key biases,
# whose exact gradient is 0 (rounding noise on both sides).
# Parameters after one Adam step: Adam's first step moves each weight by
# ~lr whatever its gradient's size, so a near-zero gradient whose sign
# differs moves it 2 lr apart: held to 2.5 lr.
STEP_LR = 1e-4
STEP_TOL = dict(loss_rtol=1e-5, grad_rel=1e-4, grad_floor=1e-5,
                param_atol=2.5 * STEP_LR)
# (iii) two runs from one seed: the same dropout masks, and losses within
# 1e-5 relative. The port's embedding backward sums in a fixed order, but
# no library kernel is asked to repeat bit for bit; the measured
# difference is printed.
RERUN_RTOL = 1e-5


def train_batch(b, s, m, vocab, device, seed, padded=False):
    """bench.py's pretraining batch: ids, M distinct masked positions a
    row, MLM labels gathered at them, NSP labels [B, 1]; with ``padded``,
    rows of 64..S tokens and a padding mask, positions inside each row."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    lens = np.full(b, s)
    if padded:
        lens = rng.randint(64, s + 1, b)
        lens[0] = s
    pos = np.stack([rng.choice(int(n), m, replace=False) for n in lens]
                   ).astype(np.int32)
    mlm = np.take_along_axis(ids, pos, axis=1).astype(np.int32)
    nsp = rng.randint(0, 2, (b, 1)).astype(np.int32)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32) \
        if padded else None
    t = (lambda a: None if a is None else torch.from_numpy(a).to(device))
    return (t(ids), None, t(mask), t(pos)), (t(mlm), t(nsp))


def train_flops(cfg, b, s, m):
    """bench.py's FLOP count of one step (bench.py:135-144)."""
    h, L, v, i = (cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size,
                  cfg.intermediate_size)
    n_dense = L * (4 * h * h + 2 * h * i)
    flops_token = 6 * n_dense + 12 * L * h * s
    head = 6 * (h * h + h * v) * m + 6 * (h * h + 2 * h)
    return flops_token * b * s + head * b


def grads_at_step(opt, sink):
    """Wrap the optimizer's update (``TrainStep`` calls ``opt._apply``) to
    hand the gradients it is about to apply to sink."""
    inner = opt._apply

    def apply(step):
        sink(opt.named_parameters())
        inner(step)
    opt._apply = apply


def check_step_against_cpu(device, state, cfg_kw):
    """(ii) one fp32 TrainStep with Adam on the card and on the CPU port
    from one state: loss, every gradient, every parameter after."""
    from paddle_tpu_torch.jit import TrainStep, load_reference_state
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretraining_loss)
    from paddle_tpu_torch.optimizer import Adam
    cfg = BertConfig(**cfg_kw, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    out = []
    for where in (device, torch.device("cpu")):
        model = BertForPretraining(cfg, device=where)
        load_reference_state(model, state)
        opt = Adam(STEP_LR)
        step = TrainStep(model, pretraining_loss, opt)
        grads = {}
        grads_at_step(opt, lambda named: grads.update(
            {n: p.grad.detach().cpu().clone() for n, p in named.items()}))
        inputs, labels = train_batch(2, 128, 20, cfg.vocab_size, where,
                                     SEED + 5)
        loss = float(step(inputs, labels))
        params = {n: p.detach().cpu() for n, p in
                  opt.named_parameters().items()}
        out.append((loss, grads, params))
        del model, opt, step
    (lg, gg, pg), (lc, gc, pc) = out
    if abs(lg - lc) > STEP_TOL["loss_rtol"] * abs(lc):
        fail(f"fp32 step: loss {lg} on the card, {lc} on the CPU")
    top = max(float(g.abs().max()) for g in gc.values())
    worst_g, worst_p = 0.0, 0.0
    for n in gc:
        if gg.get(n) is None or gc[n] is None:
            fail(f"fp32 step: {n} has no gradient")
        scale = float(gc[n].abs().max())
        atol = STEP_TOL["grad_rel"] * scale + STEP_TOL["grad_floor"] * top
        err, ok = max_err(gg[n], gc[n], atol, STEP_TOL["grad_rel"])
        worst_g = max(worst_g, err / atol)
        if not ok:
            fail(f"fp32 step: gradient of {n} differs by {err} (max "
                 f"|grad| {scale})")
        err, ok = max_err(pg[n], pc[n], STEP_TOL["param_atol"], 0.0)
        worst_p = max(worst_p, err)
        if not ok:
            fail(f"fp32 step: {n} after Adam differs by {err}")
    say("train", f"fp32 TrainStep on the card vs the CPU port, BERT-base "
        f"B=2 S=128, dropout 0: loss {lg:.6f} vs {lc:.6f}; {len(gc)} "
        f"gradients, the worst at {worst_g:.3f} of its tolerance "
        f"({STEP_TOL['grad_rel']:g} of the tensor's max + "
        f"{STEP_TOL['grad_floor']:g} of the model's); parameters after Adam(lr "
        f"{STEP_LR:g}) within {worst_p:.2e} (tol {STEP_TOL['param_atol']:g})")


class DropoutRecorder:
    """Records the dropout of a run: for each hidden dropout, a checksum
    of its exact keep mask (regenerated from a copy of the generator's
    state); for each attention dropout, the seed drawn (the pattern is a
    function of the seed alone, as the parity phase shows bit for bit)."""

    def __init__(self):
        import paddle_tpu_torch.nn.functional as PF
        from paddle_tpu_torch.kernels import flash_attention as FA
        self.PF, self.FA = PF, FA
        self.hidden, self.seeds = [], []
        self._dropout, self._draw = PF.dropout, FA.draw_seed

    def __enter__(self):
        def dropout(x, p=0.5, training=True, mode="upscale_in_train",
                    generator=None):
            if training and p > 0.0:
                from paddle_tpu_torch.layers.helper import default_generator
                gen = generator or default_generator(x.device)
                twin = torch.Generator(device=x.device)
                twin.set_state(gen.get_state())
                keep = torch.rand(x.shape, generator=twin,
                                  device=x.device) >= p
                n = keep.numel()
                w = (torch.arange(n, device=x.device) * 2654435761) % 2 ** 31
                self.hidden.append(torch.stack(
                    [keep.sum(), (keep.view(-1) * w).sum()]))
            return self._dropout(x, p, training, mode, generator)

        def draw(generator):
            value = self._draw(generator)
            self.seeds.append(value)
            return value
        self.PF.dropout, self.FA.draw_seed = dropout, draw
        return self

    def __exit__(self, *exc):
        self.PF.dropout, self.FA.draw_seed = self._dropout, self._draw
        return False

    def checksums(self):
        return torch.stack(self.hidden).cpu() if self.hidden else None


KERNEL_COUNTS = (("layer_norm_fwd", "LN", "launches"),
                 ("layer_norm_bwd", "LN", "launches_bwd"),
                 ("flash_attention_fwd", "FA", "launches"),
                 ("flash_attention_bwd_dq", "FA", "launches_dq"),
                 ("flash_attention_bwd_dkv", "FA", "launches_dkv"),
                 ("flash_attention_fwd_copies", "FA", "fwd_copies"))


def reset_counts():
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    mods = {"LN": LN, "FA": FA}
    for _, mod, attr in KERNEL_COUNTS:
        setattr(mods[mod], attr, 0)


def read_counts():
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    mods = {"LN": LN, "FA": FA}
    return {name: getattr(mods[mod], attr) for name, mod, attr in
            KERNEL_COUNTS}


def train_run(device, state, batch, steps, record):
    """BERT-base (BertConfig(), dropout on) from ``state`` under seed SEED,
    TrainStep(Adam, bf16 auto_cast), ``steps`` steps on one batch. Returns
    (losses, counts, (attention paths, layer-norm paths), recorder,
    model)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.jit import TrainStep, load_reference_state
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretraining_loss)
    from paddle_tpu_torch.nn.functional import (layer_norm_paths_taken,
                                                reset_layer_norm_path_log)
    from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                                 reset_attention_path_log)
    from paddle_tpu_torch.optimizer import Adam
    model = BertForPretraining(BertConfig(), device=device)
    load_reference_state(model, state)
    opt = Adam(TRAIN_LR)
    step = TrainStep(model, pretraining_loss, opt, amp_dtype="bfloat16")
    bad = []

    def check(named):
        missing = [n for n, p in named.items() if p.grad is None]
        finite = bool(torch.stack([torch.isfinite(p.grad).all() for p in
                                   named.values() if p.grad is not None]
                                  ).all())
        bad.append((missing, finite))
    if record:
        grads_at_step(opt, check)
    paddle_tpu_torch.seed(SEED)
    with DropoutRecorder() as rec:
        torch.cuda.synchronize()
        reset_counts()
        reset_attention_path_log()
        reset_layer_norm_path_log()
        losses = [float(step(*batch)) for _ in range(steps)]
        torch.cuda.synchronize()
        counts = read_counts()
        paths = (attention_paths_taken(), layer_norm_paths_taken())
    for missing, finite in bad:
        if missing or not finite:
            fail(f"main path: gradients missing {missing[:5]} or not "
                 f"finite ({finite})")
    return losses, counts, paths, rec, (model, opt, step)


def check_main_path(device, state, cfg):
    """(iii) the training main path, twice from one seed, then one fp32
    step with the padding mask. Returns the first run's launch counts and
    its model, optimizer and step."""
    batch = train_batch(TRAIN_B, TRAIN_S, TRAIN_M, cfg.vocab_size, device, 0)
    t0 = time.perf_counter()
    losses, counts, (paths, ln_paths), rec, keep = train_run(
        device, state, batch, TRAIN_STEPS, record=True)
    say("train", f"main path: BERT-base dropout 0.1/0.1, B={TRAIN_B} "
        f"S={TRAIN_S} M={TRAIN_M}, Adam({TRAIN_LR:g}), bf16 auto_cast, "
        f"{TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"main path: losses not finite or not lower at the end: "
             f"{losses}")
    n_ln = 2 * cfg.num_hidden_layers + 2
    # the q, k, v the forward gets are aligned views of the fused
    # projection: it copies none of them
    per_step = {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
                "flash_attention_fwd": cfg.num_hidden_layers,
                "flash_attention_bwd_dq": cfg.num_hidden_layers,
                "flash_attention_bwd_dkv": cfg.num_hidden_layers,
                "flash_attention_fwd_copies": 0}
    for name, n in per_step.items():
        if counts[name] != n * TRAIN_STEPS:
            fail(f"main path: {name} launched {counts[name]} times in "
                 f"{TRAIN_STEPS} steps, want {n} a step")
    if set(paths) != {"flash"} or \
            len(paths) != cfg.num_hidden_layers * TRAIN_STEPS:
        fail(f"main path: attention path log is not all 'flash': "
             f"{sorted(set(paths))} x {len(paths)}")
    if set(ln_paths) != {"kernel"} or len(ln_paths) != n_ln * TRAIN_STEPS:
        fail(f"main path: layer-norm path log is not all 'kernel': "
             f"{sorted(set(ln_paths))} x {len(ln_paths)}")
    say("train", "main path launches in "
        f"{TRAIN_STEPS} steps: " + ", ".join(f"{k} {v}" for k, v in
                                             counts.items()) +
        f" ({', '.join(f'{v} a step' for v in per_step.values())}); path "
        f"logs {len(paths)} x 'flash', {len(ln_paths)} x 'kernel'; every "
        "parameter's gradient present and finite at every step")
    del keep
    torch.cuda.empty_cache()

    losses2, counts2, _, rec2, keep2 = train_run(device, state, batch,
                                                 TRAIN_STEPS, record=False)
    sums1, sums2 = rec.checksums(), rec2.checksums()
    if rec.seeds != rec2.seeds or sums1 is None or \
            not torch.equal(sums1, sums2):
        fail("main path: two runs from one seed drew different dropout")
    rel = max(abs(a - b) / abs(a) for a, b in zip(losses, losses2))
    if rel > RERUN_RTOL or counts2 != counts:
        fail(f"main path: rerun losses differ by {rel} relative "
             f"(tol {RERUN_RTOL}) or launches {counts2} != {counts}")
    say("train", f"rerun from seed {SEED}: {len(rec.seeds)} attention "
        f"dropout seeds and {len(sums1)} hidden keep masks identical "
        f"(checksums of the exact masks); losses within {rel:.2e} "
        f"relative (tol {RERUN_RTOL:g}), "
        f"{'bitwise equal' if losses == losses2 else 'not bitwise equal'}")

    # one fp32 step at B=8 S=512 with the padding mask
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import pretraining_loss
    from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                                 reset_attention_path_log)
    from paddle_tpu_torch.optimizer import Adam
    model = keep2[0]
    step32 = TrainStep(model, pretraining_loss, Adam(TRAIN_LR))
    padded = train_batch(8, TRAIN_S, TRAIN_M, cfg.vocab_size, device, 1,
                         padded=True)
    reset_counts()
    reset_attention_path_log()
    loss = float(step32(*padded))
    torch.cuda.synchronize()
    c32 = read_counts()
    if not math.isfinite(loss) or any(c32[k] != v for k, v in
                                      per_step.items()) or \
            set(attention_paths_taken()) != {"flash"}:
        fail(f"fp32 padded step: loss {loss}, launches {c32}")
    say("train", f"fp32 step B=8 S=512 with the padding mask: loss "
        f"{loss:.4f}, launches " + ", ".join(f"{k} {v}" for k, v in
                                             c32.items()))
    return counts, keep2


def profiled_ms(fn, reps=5):
    """Device time of one call in ms for calls a CUDA graph cannot hold
    (autograd's backward of a library call, a library call that draws
    random numbers): the summed durations of its kernels in a
    torch.profiler trace, so the host's gaps between launches are left
    out. A trace that holds no device event at all (the profiler
    sometimes records none) is taken again, up to three times; then the
    calls are timed with CUDA events, gaps included, and that is said."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy > 0:
            return busy / 1e3 / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    say("times", "profiler traces held no device event: timed with CUDA "
        "events instead")
    return start.elapsed_time(end) / reps


# (rows, F, x dtype) timed: the train step's norm in each dtype, and a
# wide row
LN_BWD_TIME_CASES = ((16384, 768, torch.float32),
                     (16384, 768, torch.bfloat16),
                     (16384, 768, torch.float16),
                     (2048, 8192, torch.float32),
                     (1024, 768, torch.float32))  # the static program's


def time_layer_norm_bwd(device, card):
    from paddle_tpu_torch.kernels import layer_norm as LN
    records = {}
    for rows, f, dtype in LN_BWD_TIME_CASES:
        per = 3 * rows * f * (4 if dtype == torch.float32 else 2)
        sets = copies(lambda i: ln_bwd_case(rows, f, dtype, False, device,
                                            400 + i), per)
        kern = [lambda s=s: LN._launch_bwd(*s) for s in sets]
        plain = [lambda s=s: LN.layer_norm_backward_reference(*s)
                 for s in sets]

        def lib_args(s):
            dy, x, gamma, _, _ = s
            g = gamma.to(dtype)
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                x, [f], g, torch.zeros_like(g), 1e-12)
            return dy, x, mean, rstd, g
        lsets = [lib_args(s) for s in sets]
        lib = [lambda a=a: torch.ops.aten.native_layer_norm_backward(
            a[0], a[1], [f], a[2], a[3], a[4], torch.zeros_like(a[4]),
            [True, True, True]) for a in lsets]
        ms, plain_ms, lib_ms = (device_ms(fns) for fns in (kern, plain, lib))
        dy, x, gamma = sets[0][0], sets[0][1], sets[0][2]
        esz = x.element_size()
        nbytes = 3 * x.numel() * esz + 2 * rows * 4 + \
            3 * f * gamma.element_size()
        bms, by = bound_ms(nbytes, 13 * x.numel(), dtype)
        records[(rows, f, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, bound_ms=bms,
                                         bound_by=by)
        say("times", f"layer_norm_bwd [{rows}x{f}] {dtype}: kernel "
            f"{ms:.4f} ms, bound {bms:.4f} ms ({by}), plain {plain_ms:.4f} "
            f"ms, aten.native_layer_norm_backward {lib_ms:.4f} ms  [{card}]")
    return records


def bwd_work(q, k, bias, which):
    """(bytes, flops) of the dQ or the dK/dV kernel, non-causal: dQ does
    s, dp and ds k (6 Sq Sk D a head), dK/dV s, dp, dV and dK (8)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    esz = q.element_size()
    if which == "dq":
        nbytes = (4 * b * h * sq * d + 2 * b * h * sk * d) * esz + \
            2 * b * h * sq * 4
        flops = 6 * b * h * sq * sk * d
    else:
        nbytes = (2 * b * h * sq * d + 4 * b * h * sk * d) * esz + \
            2 * b * h * sq * 4
        flops = 8 * b * h * sq * sk * d
    if bias is not None:
        nbytes += b * sk * 4
    return nbytes, flops


# (b, h, s, d, padding bias, dtype, keep_prob): keep_prob < 1 is seed-mode
# dropout, the main path's call
TIME_BWD_CASES = ((32, 12, 512, 64, False, torch.bfloat16, 1.0),
                  (32, 12, 512, 64, True, torch.bfloat16, 1.0),
                  (32, 12, 512, 64, False, torch.bfloat16, KEEP_PROB),
                  (32, 12, 512, 64, False, torch.float16, 1.0),
                  (8, 12, 512, 64, False, torch.float32, 1.0),
                  # the static program's attention
                  (8, 12, 128, 64, False, torch.float32, 1.0)) + tuple(
    (*D256_SHAPE, False, dtype, 1.0)
    for dtype in (torch.bfloat16, torch.float16, torch.float32))


def time_flash_bwd(device, card):
    """The dQ and the dK/dV kernels each alone (the dK/dV kernel reads the
    delta a dQ launch wrote before), their sum, the plain backward, and
    SDPA's backward (one autograd call for dq, dk and dv, with
    dropout_p = 1 - keep_prob where the kernels drop: the library's time
    for both rows, its kernels' time from the profiler). The forward with
    seed dropout is time_flash's."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as FA
    records = {}
    tiles = source_constants(("kThreads", "kTile", "kStages"),
                             "flash_attention_bwd.cu", "flash_wgmma.cuh")
    say("times", "flash backward bf16 tiling: a CTA of "
        f"{tiles['kThreads']} threads owns {tiles['kTile']} rows, "
        f"{tiles['kStages']} stages of {tiles['kTile']}-row tiles")
    for b, h, s, d, with_bias, dtype, kp in TIME_BWD_CASES:
        q, k, v, do = attn_grad_inputs(b, h, s, s, d, dtype, device,
                                       "contiguous", 500)
        bias = padding_bias(b, s, device, 501) if with_bias else None
        seed_t = FA.seed_tensor(502, device) if kp < 1.0 else None
        scale = 1.0 / math.sqrt(d)
        o, lse = FA._launch_fwd(q, k, v, bias, False, scale, None, seed_t,
                                kp)
        args, grads, held = FA.bwd_args(do, q, k, v, o, lse, bias, False,
                                        scale, None, seed_t, kp)
        fns = {w: FA.bwd_kernel(w) for w in ("dq", "dkv")}
        fns["dq"](*args, _build.stream_ptr(device))
        ms = {w: device_ms([lambda f=f: f(*args, _build.stream_ptr(device))])
              for w, f in fns.items()}
        keep = None if seed_t is None else FA.philox_keep_mask(
            502, b, h, s, s, kp, device=device)
        plain_ms = device_ms([lambda: FA.attention_backward_reference(
            do, q, k, v, o, lse, bias, False, scale, keep, kp)], reps=3)
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        mask = None if bias is None else bias > -1.0
        out = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, scale=scale, dropout_p=1.0 - kp)
        lib_ms = profiled_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True))
        what = (f"[{b},{h},{s},{d}] {dtype} bias="
                f"{'[B,1,1,S]' if with_bias else 'none'}" +
                (f" seed dropout keep {kp}" if kp < 1.0 else ""))
        for w in ("dq", "dkv"):
            nbytes, flops = bwd_work(q, k, bias, w)
            bms, by = bound_ms(nbytes, flops, dtype)
            records[(b, h, s, d, with_bias, dtype, kp, w)] = dict(
                ms=ms[w], plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by)
            say("times", f"flash_bwd_{w} {what}: kernel {ms[w]:.4f} ms, "
                f"bound {bms:.4f} ms ({by}), plain backward {plain_ms:.4f} "
                f"ms, SDPA backward {lib_ms:.4f} ms  [{card}]")
        pair = ms["dq"] + ms["dkv"]
        lib = "SDPA's whole backward" + (
            f" with dropout_p={1.0 - kp:g}" if kp < 1.0 else "")
        say("times", f"flash backward pair {what}: dQ + dK/dV {pair:.4f} ms "
            f"against {lib} {lib_ms:.4f} ms ({pair / lib_ms:.2f}x)  [{card}]")
        del held, grads, out, ql, kl, vl, keep
    torch.cuda.empty_cache()
    return records


TRAIN_GROUPS = (("flash attention fwd", ("flash_fwd",)),
                ("flash attention bwd", ("flash_bwd",)),
                ("layer norm fwd", ("layer_norm_fwd",)),
                ("layer norm bwd", ("layer_norm_bwd",)),
                ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
                ("casts and copies", ("copy",)))


def profile_step(fn):
    """One call of ``fn`` under torch.profiler: (device busy ms, kernels,
    busy ms by TRAIN_GROUPS group, [ms, count] by kernel name). A trace
    with no device event (the profiler sometimes records none) is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events()):
            break
    else:
        fail("three profiler traces of a step held no device event")
    groups = {g: 0.0 for g, _ in TRAIN_GROUPS}
    groups["other (elementwise, optimizer, loss)"] = 0.0
    by_name = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        t = e.time_range.elapsed_us() / 1e3
        group = next((g for g, keys in TRAIN_GROUPS
                      if any(key in e.name for key in keys)),
                     "other (elementwise, optimizer, loss)")
        groups[group] += t
        ms_n = by_name.setdefault(e.name[:90], [0.0, 0])
        ms_n[0] += t
        ms_n[1] += 1
    return sum(groups.values()), n_kernels, groups, by_name


def time_train_step(step, batch, cfg, card, reps=10):
    """The main path's step: eager ms (host clock, synchronised, median),
    tokens/s, MFU at 989 TFLOP/s with bench.py's FLOP count, and from
    torch.profiler the device busy time by kernel group and the idle
    share 1 - busy / eager."""
    for _ in range(2):
        step(*batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times))
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, TRAIN_B, TRAIN_S, TRAIN_M)
    mfu = flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    busy, n_kernels, groups, by_name = profile_step(lambda: step(*batch))
    if busy <= 0.0:
        say("times", "train step: the profiler saw no device time; device "
            "ms and idle share not measured")
        busy = float("nan")
    idle = max(0.0, 1.0 - busy / ms)
    say("times", f"train step BERT-base B={TRAIN_B} S={TRAIN_S} bf16: eager "
        f"{ms:.2f} ms median of {reps}, {tokens / ms * 1e3:.0f} tokens/s, "
        f"MFU {mfu:.4f} ({flops / 1e12:.3f} TFLOP a step at 989 TFLOP/s); "
        f"device busy {busy:.2f} ms in {n_kernels} kernels, idle share "
        f"{idle:.3f}  [{card}]")
    say("profile", "train step device time: " + ", ".join(
        f"{g} {t:.2f} ms ({t / busy:.0%})" for g, t in groups.items()) +
        f"  [{card}]")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    say("profile", "train step top kernels: " + "; ".join(
        f"{name} {t:.2f} ms x{n}" for name, (t, n) in top) + f"  [{card}]")
    return dict(ms=ms, tokens_per_s=tokens / ms * 1e3, mfu=mfu,
                device_ms=busy, idle_share=idle)


# ---------------------------------------------------------------------------
# phase 6: the BERT training recipe
# ---------------------------------------------------------------------------

# Paddle's BERT pretraining recipe: linear warmup into a linear decay,
# GradientClipByGlobalNorm(1.0), AdamW(weight_decay 0.01) or Lamb(0.01)
# with L2Decay(1e-4); in fp16, dynamic loss scaling.
RECIPE_LR = 1e-4
# (i) the fp32 recipe on the card against the CPU port: three steps (lr
# 0, 2.5e-5, 5e-5 of the warmup), B=2 S=128, dropout 0, held at STEP_TOL;
# the parameters after a step within 2.5 times that step's lr (STEP_TOL's
# rule), and each step's update (parameters after minus before) per
# tensor: |d_card - d_cpu| <= UPDATE_RTOL |d_cpu| in the 2-norm. An update
# that did nothing or flipped sign is off by 1 or 2 of |d_cpu|. Sound
# arithmetic in another order: 2.2e-5 at most in tests/test_torch_train.py
# (port vs JAX on the CPU), 1.73e-4 (AdamW) and 2.36e-4 (Lamb) on the
# card, each in a layer norm's 768 values: the rules' m / (sqrt(v) + eps)
# is free of the gradient's scale, so an element's update follows its
# gradient's relative error, large where the gradient is small beside
# the tensor's max (STEP_TOL holds gradients to a share of the max; the
# worst element's gradient was 2e-4 of it). The worst element is
# printed with its gradient. The key projection's bias is held
# elementwise only: its exact gradient is 0 (a softmax row is unchanged
# by q . b_k added to every score), so its update is rounding noise on
# either device.
RECIPE_CHECK_STEPS = 3
UPDATE_RTOL = 1e-3
# (ii) the fp16 eager loop at the main path's batch, as many steps
RECIPE_STEPS = 10
RECIPE_INIT_SCALE = 2.0 ** 15
# (iii) the overflow run: 2^32 / 2560 masked positions is far past fp16's
# 65504 in the MLM decoder's gradient; the scale halves on every skip
# (decr_every_n_nan_or_inf 1) and the run goes on until RECIPE_STEPS steps
# were applied. Other fp16 weight gradients overflow down to ~2^18, so the
# first 13-16 steps are skipped: 40 steps leave room.
OVERFLOW_EXPONENTS = (32, 36, 40)
OVERFLOW_MAX_STEPS = 40
# (iv) steps counted under torch.cuda.set_sync_debug_mode
SYNC_STEPS = 5


def recipe_optimizer(which, parameters=None):
    """The recipe's optimizer: AdamW(0.01), or Lamb(0.01) with L2Decay
    (1e-4), under the global-norm clip and the schedule."""
    from paddle_tpu_torch import optimizer as O
    sched = O.LinearLrWarmup(
        O.PolynomialDecay(RECIPE_LR, decay_steps=1000, end_learning_rate=0.0,
                          power=1.0), warmup_steps=4, start_lr=0.0,
        end_lr=RECIPE_LR)
    clip = O.GradientClipByGlobalNorm(1.0)
    if which == "adamw":
        return O.AdamW(sched, weight_decay=0.01, grad_clip=clip,
                       parameters=parameters)
    return O.Lamb(sched, lamb_weight_decay=0.01, grad_clip=clip,
                  regularization=O.L2Decay(1e-4), parameters=parameters)


class RecipeRecorder:
    """Records what an optimizer's update saw: each step's lr, clip factor
    and the gradients after the clip, on the host."""

    def __init__(self, opt):
        self.lrs, self.factors, self.grads = [], [], []
        lr_on, clip = opt._lr_on, opt.grad_clip
        factor, apply = clip.factor, clip.eager_apply

        def rec_lr(device, step):
            self.lrs.append(lr_on(device, step))
            return self.lrs[-1]

        def rec_factor(grads):
            self.factors.append(factor(grads))
            return self.factors[-1]

        def rec_clip(pgs):
            out = apply(pgs)
            self.grads.append({opt._param_names[p]: g.detach().cpu()
                               for p, g in out})
            return out
        opt._lr_on, clip.factor, clip.eager_apply = rec_lr, rec_factor, \
            rec_clip


def check_recipe_against_cpu(device, state, which):
    """(i) RECIPE_CHECK_STEPS fp32 TrainStep steps of the recipe on the
    card and on the CPU port from one state: loss, lr, clip factor, every
    gradient after the clip, every parameter and its update at each
    step."""
    from paddle_tpu_torch.jit import TrainStep, load_reference_state
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretraining_loss)
    cfg = BertConfig(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    runs = []
    for where in (device, torch.device("cpu")):
        model = BertForPretraining(cfg, device=where)
        load_reference_state(model, state)
        opt = recipe_optimizer(which)
        step = TrainStep(model, pretraining_loss, opt)
        rec = RecipeRecorder(opt)
        inputs, labels = train_batch(2, 128, 20, cfg.vocab_size, where,
                                     SEED + 5)
        losses = []
        params = [{n: p.detach().cpu().clone() for n, p in
                   opt.named_parameters().items()}]
        for _ in range(RECIPE_CHECK_STEPS):
            losses.append(float(step(inputs, labels)))
            params.append({n: p.detach().cpu().clone() for n, p in
                           opt.named_parameters().items()})
        runs.append(dict(loss=losses, lr=[float(x) for x in rec.lrs],
                         factor=[float(x) for x in rec.factors],
                         grads=rec.grads, params=params))
        del model, opt, step, rec
        torch.cuda.empty_cache()
    gpu, cpu = runs
    worst = dict(loss=0.0, lr=0.0, factor=0.0, grad=0.0, param=0.0,
                 update=0.0)
    for key in ("loss", "lr", "factor"):
        if len(gpu[key]) != RECIPE_CHECK_STEPS or \
                len(cpu[key]) != RECIPE_CHECK_STEPS:
            fail(f"{which} recipe: {key} recorded {len(gpu[key])} / "
                 f"{len(cpu[key])} times in {RECIPE_CHECK_STEPS} steps")
        for a, b in zip(gpu[key], cpu[key]):
            rel = abs(a - b) / max(abs(b), 1e-30)
            worst[key] = max(worst[key], rel)
            if rel > STEP_TOL["loss_rtol"]:
                fail(f"{which} recipe: {key} {a} on the card, {b} on the "
                     "CPU")
    for i in range(RECIPE_CHECK_STEPS):
        gg, gc = gpu["grads"][i], cpu["grads"][i]
        top = max(float(g.abs().max()) for g in gc.values())
        if set(gg) != set(gc):
            fail(f"{which} recipe step {i}: gradients of other parameters")
        for n in gc:
            scale = float(gc[n].abs().max())
            atol = STEP_TOL["grad_rel"] * scale + STEP_TOL["grad_floor"] * top
            err, ok = max_err(gg[n], gc[n], atol, STEP_TOL["grad_rel"])
            worst["grad"] = max(worst["grad"], err / atol)
            if not ok:
                fail(f"{which} recipe step {i}: clipped gradient of {n} "
                     f"differs by {err} (max |grad| {scale})")
        atol = 2.5 * cpu["lr"][i]
        for n, want in cpu["params"][i + 1].items():
            got = gpu["params"][i + 1][n]
            err, ok = max_err(got, want, atol, 0.0)
            worst["param"] = max(worst["param"], err)
            if not ok:
                fail(f"{which} recipe step {i}: {n} differs by {err} (tol "
                     f"{atol:g}, 2.5 lr)")
            if cpu["lr"][i] == 0.0 or n.endswith("k_proj.bias"):
                continue
            d_gpu = got.double() - gpu["params"][i][n].double()
            d_cpu = want.double() - cpu["params"][i][n].double()
            off, norm = float((d_gpu - d_cpu).norm()), float(d_cpu.norm())
            rel = off / norm if norm else (0.0 if off == 0.0 else math.inf)
            e = (d_gpu - d_cpu).abs().flatten()
            j = int(e.argmax())
            elem = (f"{n} step {i}: {rel:.3e} of its norm, its worst element "
                    f"off by {float(e[j]) / cpu['lr'][i]:.2e} lr where the "
                    f"clipped gradient is {float(gc[n].flatten()[j]):.3e} "
                    f"(card {float(gg[n].flatten()[j]):.3e}; the tensor's "
                    f"max {float(gc[n].abs().max()):.3e})")
            if rel >= worst["update"]:
                worst["update"], worst["update_at"] = rel, elem
            if not rel <= UPDATE_RTOL:
                fail(f"{which} recipe: the update of {elem} away from the "
                     f"CPU port's (tol {UPDATE_RTOL:g})")
    say("recipe", f"fp32 {which} recipe on the card vs the CPU port, "
        f"BERT-base B=2 S=128, dropout 0, {RECIPE_CHECK_STEPS} steps: losses "
        + " ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(gpu["loss"],
                                                     cpu["loss"])) +
        f"; lr {gpu['lr']} (worst {worst['lr']:.1e} relative); clip factor "
        + " ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(gpu["factor"],
                                                     cpu["factor"])) +
        f" (worst {worst['factor']:.1e}); clipped gradients at "
        f"{worst['grad']:.3f} of their tolerance; parameters within "
        f"{worst['param']:.2e} (2.5 lr of each step); updates of the steps "
        f"with lr > 0 within {worst['update']:.2e} of their norm (tol "
        f"{UPDATE_RTOL:g}; the worst: {worst.get('update_at')})")


class LaunchDtypes:
    """Records the dtype each kernel launch of the path was given (its
    counts are untouched: the launch functions run as they are)."""

    WRAPPED = (("FA", "_launch_fwd", "flash_attention_fwd", 0),
               ("FA", "_launch_bwd", "flash_attention_bwd", 1),
               ("LN", "_launch", "layer_norm_fwd", 0),
               ("LN", "_launch_bwd", "layer_norm_bwd", 1))

    def __init__(self):
        from paddle_tpu_torch.kernels import flash_attention as FA
        from paddle_tpu_torch.kernels import layer_norm as LN
        self.mods = {"FA": FA, "LN": LN}
        self.seen = {name: set() for _, _, name, _ in self.WRAPPED}
        self._saved = []

    def __enter__(self):
        for mod, attr, name, arg in self.WRAPPED:
            fn = getattr(self.mods[mod], attr)
            self._saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _name=name, _arg=arg):
                self.seen[_name].add(str(a[_arg].dtype).replace("torch.", ""))
                return _fn(*a)
            setattr(self.mods[mod], attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(self.mods[mod], attr, fn)
        return False


def snapshot(opt, params):
    """Copies of every parameter and accumulator, and the step count."""
    return ([p.detach().clone() for p in params],
            {i: {k: v.clone() for k, v in opt._accumulators.get(p, {}).items()}
             for i, p in enumerate(params)}, opt._eager_step_count)


def same_as(snap, opt, params):
    values, accs, count = snap
    if count != opt._eager_step_count:
        return False
    for i, p in enumerate(params):
        now = opt._accumulators.get(p, {})
        if not torch.equal(values[i], p.detach()) or \
                set(now) != set(accs[i]) or \
                not all(torch.equal(v, accs[i][k]) for k, v in now.items()):
            return False
    return True


def scaling_after(init, found, incr_every=1000, decr_every=2):
    """update_loss_scaling's rule at its default ratios (x2, x0.5),
    written out: (scale, good steps, bad steps) after each step, given
    which steps found an inf or a nan."""
    scale, good, bad, out = init, 0, 0, []
    for inf in found:
        good, bad = (0, bad + 1) if inf else (good + 1, 0)
        if bad >= decr_every:
            scale, bad = max(scale * 0.5, 1.0), 0
        elif good >= incr_every:
            scale, good = scale * 2.0, 0
        out.append((scale, good, bad))
    return out


def expected_scales(init, skipped, incr_every, decr_every):
    """The scale before each step, given which were skipped: the JAX
    package's GradScaler keeps scaling_after's rule."""
    after = scaling_after(init, skipped, incr_every, decr_every)
    return [init] + [scale for scale, _, _ in after][:-1]


def fp16_recipe_run(device, state, batch, init_scale, decr_every, applied,
                    max_steps, check_skips):
    """The eager fp16 recipe on BERT-base (dropout on) from ``state`` under
    seed SEED: auto_cast(float16) forward, the loss outside it,
    scaler.scale(loss).backward(), scaler.minimize(opt, scaled),
    opt.clear_grad(); until ``applied`` steps were applied or
    ``max_steps`` ran. Counts are set to 0 just before and read just
    after. With ``check_skips`` every skipped step is held bitwise against
    a snapshot taken before it."""
    import paddle_tpu_torch
    from paddle_tpu_torch.amp import GradScaler, auto_cast
    from paddle_tpu_torch.jit import load_reference_state
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretraining_loss)
    from paddle_tpu_torch.nn.functional import (layer_norm_paths_taken,
                                                reset_layer_norm_path_log)
    from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                                 reset_attention_path_log)
    model = BertForPretraining(BertConfig(), device=device)
    load_reference_state(model, state)
    model.train()
    params = list(model.parameters())
    opt = recipe_optimizer("adamw", parameters=params)
    scaler = GradScaler(init_loss_scaling=init_scale,
                        decr_every_n_nan_or_inf=decr_every)
    inputs, labels = batch
    losses, scales, skipped, unchanged = [], [], [], []
    paddle_tpu_torch.seed(SEED)
    with LaunchDtypes() as dtypes:
        torch.cuda.synchronize()
        reset_counts()
        reset_attention_path_log()
        reset_layer_norm_path_log()
        while opt._eager_step_count < applied and len(losses) < max_steps:
            snap = snapshot(opt, params) if check_skips else None
            scales.append(scaler.get_scale())
            with auto_cast(dtype="float16"):
                out = model(*inputs)
            loss = pretraining_loss(*out, *labels)
            scaled = scaler.scale(loss)
            scaled.backward()
            scaler.minimize(opt, scaled)
            opt.clear_grad()
            skipped.append(scaler._found_inf_last)
            losses.append(loss.detach())
            if snap is not None and skipped[-1]:
                unchanged.append(same_as(snap, opt, params))
            del snap
        torch.cuda.synchronize()
        counts = read_counts()
        paths = (attention_paths_taken(), layer_norm_paths_taken())
    del model, opt, params
    torch.cuda.empty_cache()
    return dict(losses=[float(x) for x in losses], scales=scales,
                skipped=skipped, unchanged=unchanged, counts=counts,
                paths=paths, dtypes=dtypes.seen)


def check_fp16_launches(run, cfg, label):
    """26 layer-norm forward and backward and 12 flash forward, dQ and
    dK/dV launches a step, no forward input copied, all-"flash" and
    all-"kernel" path logs, the flash kernels on fp16."""
    steps = len(run["losses"])
    n_ln = 2 * cfg.num_hidden_layers + 2
    per_step = {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
                "flash_attention_fwd": cfg.num_hidden_layers,
                "flash_attention_bwd_dq": cfg.num_hidden_layers,
                "flash_attention_bwd_dkv": cfg.num_hidden_layers,
                "flash_attention_fwd_copies": 0}
    for name, n in per_step.items():
        if run["counts"][name] != n * steps:
            fail(f"{label}: {name} launched {run['counts'][name]} times in "
                 f"{steps} steps, want {n} a step")
    paths, ln_paths = run["paths"]
    if set(paths) != {"flash"} or len(paths) != cfg.num_hidden_layers * \
            steps:
        fail(f"{label}: attention path log is not all 'flash': "
             f"{sorted(set(paths))} x {len(paths)}")
    if set(ln_paths) != {"kernel"} or len(ln_paths) != n_ln * steps:
        fail(f"{label}: layer-norm path log is not all 'kernel': "
             f"{sorted(set(ln_paths))} x {len(ln_paths)}")
    dt = run["dtypes"]
    if dt["flash_attention_fwd"] != {"float16"} or \
            dt["flash_attention_bwd"] != {"float16"}:
        fail(f"{label}: the flash kernels ran on {dt}, want float16")
    # the norms' inputs are fp32 sums (an fp16 product plus an fp32 bias
    # promotes to fp32, as in JAX), so the norms stay fp32
    if dt["layer_norm_fwd"] != {"float32"} or \
            dt["layer_norm_bwd"] != {"float32"}:
        fail(f"{label}: the layer norms ran on {dt}, want float32 (the AMP "
             "promotion of the residual sums)")
    return per_step


def check_nonfinite_backward(device):
    """An inf in the flash backward's dO and in the layer-norm backward's
    dy gives non-finite gradients (which the scaler's flag sees), not a
    crash and not a finite value."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    q, k, v = (t.requires_grad_() for t in attn_inputs(
        2, 12, 128, 128, 64, torch.float16, device, SEED + 41))
    o = FA.flash_attention(q, k, v)
    do = torch.zeros_like(o)
    do[0, 3, 5, 7] = float("inf")
    o.backward(do)
    x, gamma, beta = ln_inputs(256, 768, torch.float32, device, SEED + 42)
    x.requires_grad_()
    y = LN.layer_norm(x, gamma, beta)
    dy = torch.zeros_like(y)
    dy[17, 100] = float("inf")
    y.backward(dy)
    torch.cuda.synchronize()
    bad = {n: bool(torch.isfinite(t.grad).all()) for n, t in
           (("dq", q), ("dk", k), ("dv", v), ("dx", x))}
    if any(bad.values()):
        fail(f"an inf in dO / dy left these gradients finite: {bad}")
    say("recipe", "an inf in the fp16 flash backward's dO and in the layer "
        "norm backward's dy: dq, dk, dv and dx each hold non-finite values")


def sync_sites(fn):
    """The host syncs of ``fn``, counted under
    torch.cuda.set_sync_debug_mode("warn") over SYNC_STEPS calls: {site:
    syncs a call}, the site being the innermost frame of the stack in the
    port's package (else in this repo, else the warning's own frame), so a
    sync asked for through torch's Python code is laid at the line of the
    port that called it. Only warnings raised inside ``fn`` count: setting
    the mode can raise one of its own."""
    import collections
    import os
    import traceback
    import warnings
    root = os.path.dirname(os.path.abspath(__file__))
    package = os.path.join(root, "paddle_tpu_torch") + os.sep
    sites = collections.Counter()
    inside = [False]

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        frames = [(os.path.abspath(f.filename), f.lineno)
                  for f in traceback.extract_stack()[:-1]]
        inner = [x for x in frames if x[0].startswith(package)] or \
            [x for x in frames if x[0].startswith(root + os.sep)] or \
            [(os.path.abspath(filename), lineno)]
        f, n = inner[-1]
        sites[f"{os.path.relpath(f, root)}:{n}"] += 1
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(SYNC_STEPS):
                inside[0] = True
                fn()
                inside[0] = False
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {k: v / SYNC_STEPS for k, v in sites.items()}


def time_recipe(device, state, cfg, card, reps=10):
    """(iv) the recipe's steps at the main path's batch beside the plain
    Adam step, all four built first and timed in turns: step ms (host
    clock, synchronised, median), device busy ms and kernels a step
    (torch.profiler), host syncs a step, in all and by the line of the port
    that asked (the clip and the schedule add none to plain Adam's, the
    scaler one)."""
    from paddle_tpu_torch.amp import GradScaler, auto_cast
    from paddle_tpu_torch.jit import TrainStep, load_reference_state
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretraining_loss)
    from paddle_tpu_torch.optimizer import Adam
    batch = train_batch(TRAIN_B, TRAIN_S, TRAIN_M, cfg.vocab_size, device, 0)

    def train_step(opt):
        def make(model):
            step = TrainStep(model, pretraining_loss, opt,
                             amp_dtype="bfloat16")
            return lambda: step(*batch)
        return make

    def fp16_eager(model):
        model.train()
        opt = recipe_optimizer("adamw", parameters=model.parameters())
        scaler = GradScaler(init_loss_scaling=RECIPE_INIT_SCALE)

        def step():
            with auto_cast(dtype="float16"):
                out = model(*batch[0])
            scaled = scaler.scale(pretraining_loss(*out, *batch[1]))
            scaled.backward()
            scaler.minimize(opt, scaled)
            opt.clear_grad()
        return step

    cases = (("Adam(1e-4) bf16 TrainStep", train_step(Adam(TRAIN_LR))),
             ("AdamW recipe bf16 TrainStep",
              train_step(recipe_optimizer("adamw"))),
             ("Lamb recipe bf16 TrainStep",
              train_step(recipe_optimizer("lamb"))),
             ("AdamW recipe fp16 eager + GradScaler", fp16_eager))
    fns = {}
    for label, make in cases:
        model = BertForPretraining(BertConfig(), device=device)
        load_reference_state(model, state)
        fns[label] = make(model)
        for _ in range(2):
            fns[label]()
    torch.cuda.synchronize()
    times = {label: [] for label in fns}
    for _ in range(reps):
        for label, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    out = {}
    for label, fn in fns.items():
        ms = 1e3 * float(np.median(times[label]))
        sites = sync_sites(fn)
        busy, n_kernels, _, _ = profile_step(fn)
        out[label] = dict(ms=ms, device_ms=busy, kernels=n_kernels,
                          syncs=sum(sites.values()), sites=sites)
        say("recipe", f"times: {label}, BERT-base B={TRAIN_B} S={TRAIN_S} "
            f"M={TRAIN_M}: step {ms:.2f} ms median of {reps} (in turns), "
            f"device busy {busy:.2f} ms in {n_kernels} kernels, idle share "
            f"{max(0.0, 1.0 - busy / ms):.3f}, host syncs a step "
            f"{sum(sites.values()):g} " + str(sites) + f"  [{card}]")
    del fns
    torch.cuda.empty_cache()
    # the clip and the schedule add no sync to plain Adam's step, the
    # scaler exactly one (its non-finite flag, read once a step); the
    # totals are compared, whatever line asked
    plain = out[cases[0][0]]["syncs"]
    for label, r in out.items():
        scaler = "GradScaler" in label
        want = plain + (1 if scaler else 0)
        scaler_syncs = sum(n for site, n in r["sites"].items()
                           if site.startswith("paddle_tpu_torch/amp.py:"))
        if r["syncs"] > want or scaler_syncs != (1 if scaler else 0):
            fail(f"{label}: host syncs a step {r['syncs']:g} {r['sites']}, "
                 f"plain Adam's {plain:g}: the clip and the schedule must "
                 "add none, the scaler one")
    return out


def run_recipe(device, state, cfg, card):
    """Phase 6. Returns the fp16 main path's launch counts."""
    # (i) the fp32 recipe on the card against the CPU port
    for which in ("adamw", "lamb"):
        check_recipe_against_cpu(device, state, which)
    check_nonfinite_backward(device)
    batch = train_batch(TRAIN_B, TRAIN_S, TRAIN_M, cfg.vocab_size, device, 0)

    # (ii) the fp16 eager recipe, the main path: counts set to 0 just
    # before, read just after
    t0 = time.perf_counter()
    run = fp16_recipe_run(device, state, batch, RECIPE_INIT_SCALE, 2,
                          applied=RECIPE_STEPS, max_steps=RECIPE_STEPS,
                          check_skips=False)
    losses = run["losses"]
    say("recipe", f"fp16 main path: BERT-base dropout 0.1/0.1, B={TRAIN_B} "
        f"S={TRAIN_S} M={TRAIN_M}, AdamW(0.01) + GradientClipByGlobalNorm"
        f"(1.0) + warmup 4 into linear decay (peak {RECIPE_LR:g}), "
        f"auto_cast(float16), GradScaler({RECIPE_INIT_SCALE:g}), "
        f"{len(losses)} eager steps in {time.perf_counter() - t0:.1f} s; "
        "losses " + " ".join(f"{x:.4f}" for x in losses) + "; scales "
        + " ".join(f"{x:g}" for x in run["scales"]) + "; skipped "
        + "".join("x" if s else "." for s in run["skipped"]))
    if len(losses) != RECIPE_STEPS or not all(math.isfinite(x) for x in
                                              losses) or \
            not losses[-1] < losses[0]:
        fail(f"fp16 recipe: losses not finite or not lower at the end: "
             f"{losses}")
    per_step = check_fp16_launches(run, cfg, "fp16 recipe")
    if run["scales"] != expected_scales(RECIPE_INIT_SCALE, run["skipped"],
                                        1000, 2):
        fail(f"fp16 recipe: scales {run['scales']} do not follow the rule")
    say("recipe", f"fp16 main path launches in {RECIPE_STEPS} steps: "
        + ", ".join(f"{k} {v}" for k, v in run["counts"].items()) +
        f" ({', '.join(f'{v} a step' for v in per_step.values())}); path "
        f"logs {len(run['paths'][0])} x 'flash', {len(run['paths'][1])} x "
        f"'kernel'; kernel dtypes {run['dtypes']}")
    counts = run["counts"]

    # (iii) the overflow path
    for exp in OVERFLOW_EXPONENTS:
        over = fp16_recipe_run(device, state, batch, 2.0 ** exp, 1,
                               applied=RECIPE_STEPS,
                               max_steps=OVERFLOW_MAX_STEPS,
                               check_skips=True)
        if over["skipped"][0]:
            break
        say("recipe", f"overflow run: 2^{exp} did not overflow the first "
            "step; raising the initial scale")
    else:
        fail("overflow run: no initial scale overflowed the first step")
    losses = over["losses"]
    n_skip = sum(over["skipped"])
    say("recipe", f"overflow run from 2^{exp}, decr_every_n_nan_or_inf 1: "
        f"{len(losses)} steps, {n_skip} skipped ("
        + "".join("x" if s else "." for s in over["skipped"]) + "); scales "
        + " ".join(f"{x:g}" for x in over["scales"]) + "; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    if n_skip < 1 or not all(over["unchanged"]) or \
            len(over["unchanged"]) != n_skip:
        fail(f"overflow run: skips {over['skipped']}, skipped steps left "
             f"everything unchanged: {over['unchanged']}")
    if over["scales"] != expected_scales(2.0 ** exp, over["skipped"], 1000,
                                         1):
        fail(f"overflow run: scales {over['scales']} do not follow the rule")
    if len(losses) - n_skip != RECIPE_STEPS or \
            not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"overflow run: {len(losses) - n_skip} steps applied, losses "
             f"{losses}")
    check_fp16_launches(over, cfg, "overflow run")
    say("recipe", f"overflow run: every one of the {n_skip} skipped steps "
        "left every parameter, every accumulator and the schedule's step "
        "bitwise unchanged; the scale halved on each skip; "
        f"{RECIPE_STEPS} steps applied, losses finite and lower at the end")

    # (iv) times
    time_recipe(device, state, cfg, card)
    return counts


# ---------------------------------------------------------------------------
# phase 7: the static Program path
# ---------------------------------------------------------------------------

# the 12-layer BERT-base-shaped static train program of
# tools/check_backward_replay.py:89 build_bert_shaped, in fp32: H 768, FF
# 3072, 12 heads, S 128, B 8, Adam(1e-4)
STATIC_CFG = dict(layers_n=12, H=768, FF=3072, heads=12, S=128)
STATIC_B = 8
STATIC_CPU_B = 2
STATIC_STEPS = 10
STATIC_LR = 1e-4
STATIC_SEED = 2024
# the program's loss is the mean of the last norm's output, which is 0 for
# every input while each norm's scale is 1 and its bias 0 (the mean of a
# normalized row is 0): every gradient below the last norm would be
# rounding noise. So the checks draw the norms' scale and bias from a
# numpy seed: 1 + 0.1 N and 0.1 N.
STATIC_LN_SPREAD = 0.1
# the loss against the CPU port: a mean of ~1e5 terms of O(0.1) summed in
# other orders through 12 layers of fp32 arithmetic
STATIC_LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
# the fused form (flash) against the composed one on the card: the fp32
# flash tolerance (A, R) of FLASH_BWD_TOL, A taken as a share of each
# tensor's max |ref|, with STEP_TOL's floor of the model's largest
# gradient for the key biases, whose exact gradient is 0
STATIC_FUSED_TOL = FLASH_BWD_TOL[torch.float32]
# a verify-skill step: fc -> softmax_with_cross_entropy -> Adam(1e-3)
VERIFY_STEPS = 5


def build_bert_forward(pt, layers_n=12, H=768, FF=3072, heads=12, S=128,
                       norm_axis=1):
    """The forward of build_bert_shaped: (main, startup, loss, the output
    var of each layer, the reshaped second layer_norm)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    outs = []
    with pt.program_guard(main, startup):
        h = layers.data("x", [S, H])
        for _ in range(layers_n):
            a = layers.multi_head_attention(h, heads)
            h = layers.reshape(layers.layer_norm(
                layers.elementwise_add(a, h), begin_norm_axis=norm_axis),
                [-1, S, H])
            f = layers.fc(layers.reshape(
                layers.fc(h, FF, act="gelu", num_flatten_dims=2),
                [-1, S, FF]), H, num_flatten_dims=2)
            h = layers.reshape(layers.layer_norm(
                layers.elementwise_add(f, h), begin_norm_axis=norm_axis),
                [-1, S, H])
            outs.append(h)
        loss = layers.mean(h)
    return main, startup, loss, outs


def build_bert_shaped(pt, layers_n=12, H=768, FF=3072, heads=12, S=128,
                      norm_axis=1):
    """The program of tools/check_backward_replay.py:89 built with package
    ``pt``'s layers (the port here; the tests also pass the JAX package):
    L layers of multi_head_attention, residual, layer_norm, an FFN of two
    fc (gelu), residual, layer_norm; the mean as the loss; Adam(STATIC_LR).
    ``norm_axis`` is the norms' begin_norm_axis: 1 (the tool's, over
    S x H) or 2 (the trailing axis). Returns (main, startup, loss)."""
    main, startup, loss, _ = build_bert_forward(pt, layers_n, H, FF, heads,
                                                S, norm_axis)
    with pt.program_guard(main, startup):
        pt.optimizer.Adam(STATIC_LR).minimize(loss, startup_program=startup,
                                              program=main)
    return main, startup, loss


def static_forms(cfg=STATIC_CFG, seed=STATIC_SEED):
    """{form: (main, startup, loss name)}: (a) as built, (b) after
    multihead_matmul_fuse, (c) (b) with begin_norm_axis 2."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.passes import apply_pass
    main_a, startup_a, loss_a = build_bert_shaped(pt, **cfg)
    main_c, startup_c, loss_c = build_bert_shaped(pt, **cfg, norm_axis=2)
    for startup in (startup_a, startup_c):
        startup.random_seed = seed
    fuse = (lambda m: apply_pass(m.clone(), "multihead_matmul_fuse"))
    return {"a": (main_a, startup_a, loss_a.name),
            "b": (fuse(main_a), startup_a, loss_a.name),
            "c": (fuse(main_c), startup_c, loss_c.name)}


def static_state(startup, device, seed=STATIC_SEED):
    """The startup program run on ``device`` into a new scope, every layer
    norm's scale and bias then drawn from numpy (STATIC_LN_SPREAD): the
    state as numpy arrays by name."""
    import paddle_tpu_torch as pt
    scope = pt.Scope()
    pt.Executor(device).run(startup, scope=scope)
    rng = np.random.default_rng(seed)
    state = {}
    for name, var in startup.global_block.vars.items():
        value = scope.find_var(name).cpu().numpy()
        if var.is_parameter and name.startswith("layer_norm."):
            base = 1.0 if ".w_" in name else 0.0
            value = (base + STATIC_LN_SPREAD * rng.standard_normal(
                value.shape)).astype(np.float32)
        state[name] = value
    return state


def static_feed(b, cfg=STATIC_CFG, seed=STATIC_SEED + 1):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, cfg["S"], cfg["H"]))
            .astype(np.float32)}


class StaticRun:
    """A form's main program on ``device`` from a carried state: its
    executor, scope, feed and gradient names."""

    def __init__(self, form, state, device, b):
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.core.scope import load_reference_scope
        self.main, _, self.loss = form
        self.scope = pt.Scope()
        load_reference_scope(self.scope, state, device)
        self.exe = pt.Executor(device)
        self.feed = static_feed(b)
        self.grads = [n for n in self.main.global_block.vars
                      if n.endswith("@GRAD")]

    def step(self, grads=False):
        """One step; the loss (and the gradients), tensors on the
        device."""
        return self.exe.run(self.main, feed=self.feed,
                            fetch_list=[self.loss] + (self.grads if grads
                                                      else []),
                            scope=self.scope, return_numpy=False)

    def params(self):
        return {v.name: self.scope.find_var(v.name).cpu().clone()
                for v in self.main.all_parameters()}


def static_paths():
    from paddle_tpu_torch.nn.functional import layer_norm_paths_taken
    from paddle_tpu_torch.nn.transformer import attention_paths_taken
    return attention_paths_taken(), layer_norm_paths_taken()


def reset_static_logs():
    from paddle_tpu_torch.nn.functional import reset_layer_norm_path_log
    from paddle_tpu_torch.nn.transformer import reset_attention_path_log
    reset_attention_path_log()
    reset_layer_norm_path_log()


def static_expect(form, n_layers):
    """(launches a step by KERNEL_COUNTS name, attention path log, layer-
    norm path log) of one step of a form."""
    flash = 0 if form == "a" else n_layers
    ln = 2 * n_layers if form == "c" else 0
    counts = dict(layer_norm_fwd=ln, layer_norm_bwd=ln,
                  flash_attention_fwd=flash, flash_attention_bwd_dq=flash,
                  flash_attention_bwd_dkv=flash,
                  flash_attention_fwd_copies=0)
    return (counts, ["flash"] * flash,
            ["kernel" if form == "c" else "composed"] * (2 * n_layers))


def check_lowered(run, form, n_layers):
    """Each op of the program lowered once in the step just run: the
    executor's count by op type equals the program's; the forward has 5L
    mul and 2L matmul in (a), 2L mul, L multihead_matmul and no matmul in
    (b) and (c)."""
    import collections
    want = collections.Counter(op.type for op in run.main.global_block.ops)
    got = run.exe.lowered
    if got != want:
        fail(f"static ({form}): lowerings {dict(got)} against the program's "
             f"ops {dict(want)}")
    fwd = (dict(mul=5 * n_layers, matmul=2 * n_layers, multihead_matmul=0)
           if form == "a" else
           dict(mul=2 * n_layers, matmul=0, multihead_matmul=n_layers))
    if any(got[k] != v for k, v in fwd.items()):
        fail(f"static ({form}): {dict(got)}, expected {fwd} a step")
    return {k: got[k] for k in fwd}


def check_static_vs_cpu(forms, states, device):
    """(a) and (c) one step each at B=2 on the card and on the CPU port
    from one carried state: the loss and every @GRAD by name (STEP_TOL),
    the parameters after the update within 2.5 lr and each update in norm
    (UPDATE_RTOL; the key bias, whose exact gradient is 0, elementwise
    only)."""
    cpu = torch.device("cpu")
    for form in ("a", "c"):
        out = []
        for where in (device, cpu):
            run = StaticRun(forms[form], states[form], where, STATIC_CPU_B)
            before = run.params()
            vals = run.step(grads=True)
            out.append(dict(
                loss=float(vals[0]), params=run.params(), before=before,
                grads={n: v.cpu() for n, v in zip(run.grads, vals[1:])}))
            del run
        g, c = out
        err = abs(g["loss"] - c["loss"])
        if err > STATIC_LOSS_TOL["atol"] + STATIC_LOSS_TOL["rtol"] * \
                abs(c["loss"]):
            fail(f"static ({form}) vs CPU: loss {g['loss']} on the card, "
                 f"{c['loss']} on the CPU port")
        top = max(float(t.abs().max()) for t in c["grads"].values())
        worst_g = 0.0
        for n, want in c["grads"].items():
            scale = float(want.abs().max())
            atol = STEP_TOL["grad_rel"] * scale + STEP_TOL["grad_floor"] * top
            e, ok = max_err(g["grads"][n], want, atol, STEP_TOL["grad_rel"])
            worst_g = max(worst_g, e / atol)
            if not ok:
                fail(f"static ({form}) vs CPU: {n} differs by {e} (max "
                     f"|grad| {scale})")
        worst_p, worst_u = 0.0, 0.0
        for n, want in c["params"].items():
            e, ok = max_err(g["params"][n], want, 2.5 * STATIC_LR, 0.0)
            worst_p = max(worst_p, e)
            if not ok:
                fail(f"static ({form}) vs CPU: {n} after the update differs "
                     f"by {e} (tol 2.5 lr)")
            if ".k_b_" in n:
                continue
            d_g = g["params"][n].double() - g["before"][n].double()
            d_c = want.double() - c["before"][n].double()
            rel = float((d_g - d_c).norm()) / max(float(d_c.norm()), 1e-30)
            worst_u = max(worst_u, rel)
            if not rel <= UPDATE_RTOL:
                fail(f"static ({form}) vs CPU: the update of {n} is "
                     f"{rel:.3e} of its norm away (tol {UPDATE_RTOL:g})")
        say("static", f"({form}) card vs CPU port, B={STATIC_CPU_B}: loss "
            f"{g['loss']:.8f} / {c['loss']:.8f}; {len(c['grads'])} @GRAD at "
            f"{worst_g:.3f} of STEP_TOL; parameters within {worst_p:.2e} "
            f"(2.5 lr), updates within {worst_u:.2e} of their norm (tol "
            f"{UPDATE_RTOL:g})")


def check_static_fused(forms, states, device):
    """(b) against (a) on the card at B=8, one step each from one state:
    the loss and every gradient within STATIC_FUSED_TOL; the launches, the
    path logs and the lowerings of each step."""
    n_layers = STATIC_CFG["layers_n"]
    out = {}
    for form in ("a", "b"):
        run = StaticRun(forms[form], states["a"], device, STATIC_B)
        reset_counts()
        reset_static_logs()
        vals = run.step(grads=True)
        torch.cuda.synchronize()
        counts, paths = read_counts(), static_paths()
        want_counts, want_attn, want_ln = static_expect(form, n_layers)
        if counts != want_counts or paths != (want_attn, want_ln):
            fail(f"static ({form}): launches {counts}, paths "
                 f"{[sorted(set(p)) for p in paths]} x "
                 f"{[len(p) for p in paths]}; expected {want_counts}")
        lowered = check_lowered(run, form, n_layers)
        out[form] = dict(loss=float(vals[0]), grads={
            n: v.cpu() for n, v in zip(run.grads, vals[1:])})
        say("static", f"({form}) one step at B={STATIC_B}: launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items()) +
            f"; attention log {len(paths[0])} x "
            f"{sorted(set(paths[0])) or '-'}, layer-norm log "
            f"{len(paths[1])} x {sorted(set(paths[1]))}; lowerings {lowered} "
            f"(each of the program's {len(run.main.global_block.ops)} ops "
            "once)")
        del run
    a_, r_ = STATIC_FUSED_TOL
    top = max(float(t.abs().max()) for t in out["a"]["grads"].values())
    worst = 0.0
    for n, want in out["a"]["grads"].items():
        got = out["b"]["grads"][n]
        lim = a_ * float(want.abs().max()) + r_ * want.abs() + \
            STEP_TOL["grad_floor"] * top
        share = float(((got - want).abs() / lim.clamp_min(1e-30)).max())
        worst = max(worst, share)
        if share > 1.0:
            fail(f"static (b) vs (a): {n} off by "
                 f"{float((got - want).abs().max())} (tol {a_:g} max|ref| + "
                 f"{r_:g}|ref| + {STEP_TOL['grad_floor']:g} max grad)")
    la, lb = out["a"]["loss"], out["b"]["loss"]
    if abs(la - lb) > STATIC_LOSS_TOL["atol"] + STATIC_LOSS_TOL["rtol"] * \
            abs(la):
        fail(f"static (b) vs (a): loss {lb} against {la}")
    say("static", f"(b) vs (a) on the card: loss {lb:.8f} / {la:.8f}; every "
        f"gradient within {worst:.3f} of the fp32 flash tolerance "
        f"({a_:g} max|ref| + {r_:g}|ref|)")


def static_main_path(form, state, device):
    """STATIC_STEPS steps of a form at B=8 with the counts set to 0 just
    before and read just after: (losses, counts, paths, final params)."""
    run = StaticRun(form, state, device, STATIC_B)
    reset_counts()
    reset_static_logs()
    losses = [run.step()[0] for _ in range(STATIC_STEPS)]
    torch.cuda.synchronize()
    counts, paths = read_counts(), static_paths()
    return [float(x) for x in losses], counts, paths, run.params()


def check_verify_recipe(device):
    """The verify skill's recipe on the card: fc -> softmax_with_cross_
    entropy -> Adam(1e-3), VERIFY_STEPS steps on one batch; the loss must
    fall."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = STATIC_SEED
    with pt.program_guard(main, startup):
        x = layers.data("x", [4])
        label = layers.data("y", [1], dtype="int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(x, 10), label))
        pt.optimizer.Adam(1e-3).minimize(loss, startup_program=startup,
                                         program=main)
    scope = pt.Scope()
    exe = pt.Executor(device)
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(STATIC_SEED)
    feed = {"x": rng.standard_normal((8, 4)).astype(np.float32),
            "y": rng.integers(0, 10, (8, 1))}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(VERIFY_STEPS)]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"verify recipe on the card: losses {losses}")
    say("static", "verify recipe (fc -> softmax_with_cross_entropy -> "
        f"Adam(1e-3)) on {torch.cuda.get_device_name(0)}: losses "
        + " ".join(f"{v:.6f}" for v in losses))


class GcClock:
    """The host time spent in Python's cyclic garbage collector while the
    block runs (``ms``), and its collections by generation (``counts``)."""

    def __enter__(self):
        self.ms, self.counts, self._t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._tick)
        return self

    def _tick(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms += 1e3 * (time.perf_counter() - self._t)
            self.counts[info["generation"]] += 1
            self._t = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)


def time_runs(runs, card, phase, reps=10):
    """Each StaticRun of ``runs`` (by label), built first and timed in
    turns: eager step ms (host clock, synchronised, median of ``reps``,
    and the range), the host ms spent in the garbage collector during those
    steps (GcClock), device busy ms and kernels a step (torch.profiler),
    the idle share, and the flash and layer-norm launches a step."""
    n_layers = STATIC_CFG["layers_n"]
    for run in runs.values():
        for _ in range(2):
            run.step()
    torch.cuda.synchronize()
    times = {label: [] for label in runs}
    gc_ms = {label: 0.0 for label in runs}
    gc_n = {label: [0, 0, 0] for label in runs}
    for _ in range(reps):
        for label, run in runs.items():
            with GcClock() as clock:
                t0 = time.perf_counter()
                run.step()
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
            gc_ms[label] += clock.ms
            gc_n[label] = [a + b for a, b in zip(gc_n[label], clock.counts)]
    for label, run in runs.items():
        ms = 1e3 * float(np.median(times[label]))
        lo, hi = 1e3 * min(times[label]), 1e3 * max(times[label])
        reset_counts()
        busy, n_kernels, groups, _ = profile_step(run.step)
        counts = read_counts()
        idle = max(0.0, 1.0 - busy / ms)
        say(phase, f"times {label} BERT-shaped {n_layers} layers "
            f"B={STATIC_B} S={STATIC_CFG['S']}: step {ms:.2f} ms median of "
            f"{reps} (in turns; {lo:.2f}-{hi:.2f}), garbage collector "
            f"{gc_ms[label] / reps:.2f} ms a step ({gc_n[label]} collections "
            f"by generation in the {reps}), device busy {busy:.2f} ms in "
            f"{n_kernels} kernels, idle share {idle:.3f}; flash "
            f"{counts['flash_attention_fwd']}/"
            f"{counts['flash_attention_bwd_dq']}/"
            f"{counts['flash_attention_bwd_dkv']}, layer norm "
            f"{counts['layer_norm_fwd']}/{counts['layer_norm_bwd']} a step; "
            + ", ".join(f"{g} {t:.2f} ms" for g, t in groups.items()) +
            f"  [{card}]")


def time_static(forms, states, device, card, reps=10):
    """Each form at B=8 in fp32, timed in turns (time_runs)."""
    runs = {f"({form}) fp32": StaticRun(forms[form], states[form], device,
                                        STATIC_B) for form in ("a", "b", "c")}
    time_runs(runs, card, "static", reps)
    del runs
    torch.cuda.empty_cache()


def run_static(device, card):
    """Phase 7. Returns the main path's launch counts: STATIC_STEPS steps
    of form (c)."""
    n_layers = STATIC_CFG["layers_n"]
    t0 = time.perf_counter()
    forms = static_forms()
    states = {"a": static_state(forms["a"][1], device),
              "c": static_state(forms["c"][1], device)}
    same = [n for n in states["a"] if not n.startswith("layer_norm.")
            and "@" not in n]
    if any(not np.array_equal(states["a"][n], states["c"][n])
           for n in same):
        fail("static: the two startup programs from one seed drew "
             "different weights")
    states["b"] = states["a"]
    say("static", f"BERT-shaped program {STATIC_CFG}, three forms built and "
        f"started from seed {STATIC_SEED} in {time.perf_counter() - t0:.1f} "
        f"s; ops: " + ", ".join(f"({k}) {len(v[0].global_block.ops)}"
                                for k, v in forms.items()) +
        f"; {len(same)} weights equal across the two startups")

    check_static_vs_cpu(forms, states, device)
    torch.cuda.empty_cache()
    check_static_fused(forms, states, device)
    torch.cuda.empty_cache()

    # the main path: ten steps of (c), counts set to 0 just before
    losses, counts, paths, params = static_main_path(forms["c"],
                                                     states["c"], device)
    want_counts, want_attn, want_ln = static_expect("c", n_layers)
    want_counts = {k: STATIC_STEPS * v for k, v in want_counts.items()}
    if counts != want_counts or paths != (want_attn * STATIC_STEPS,
                                          want_ln * STATIC_STEPS):
        fail(f"static (c) main path: launches {counts} (expected "
             f"{want_counts}), paths {[sorted(set(p)) for p in paths]} x "
             f"{[len(p) for p in paths]}")
    if not all(math.isfinite(v) for v in losses) or \
            len(set(losses)) < 2 or losses[-1] == losses[0]:
        fail(f"static (c): losses not finite or not moving: {losses}")
    again, _, _, params2 = static_main_path(forms["c"], states["c"], device)
    diff = max(float((params[n] - params2[n]).abs().max()) for n in params)
    if again != losses or diff != 0.0:
        fail(f"static (c) rerun: losses {again} against {losses}, "
             f"parameters off by up to {diff}")
    say("static", f"(c) main path, {STATIC_STEPS} steps at B={STATIC_B}: "
        "losses " + " ".join(f"{v:.8f}" for v in losses) + "; launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items()) +
        f"; path logs {len(paths[0])} x 'flash', {len(paths[1])} x "
        "'kernel'; a rerun from the same state is bitwise equal (losses and "
        "every parameter)")
    check_verify_recipe(device)
    time_static(forms, states, device, card)
    return counts


# ---------------------------------------------------------------------------
# phase 8: generation
# ---------------------------------------------------------------------------

# the decoder of docs/generation.md at full width and depth: 267.5 M
# parameters, 1.07 GB in fp32
GEN_CFG = dict(vocab_size=32000, hidden=1024, layers=16, heads=16)
# engine geometry chosen for the card: a 2 GiB fp32 pool (1 MiB of K and
# 1 MiB of V a block), 16 lanes, 64-token prefill chunks, 80 slots a step
GEN_GEO = dict(num_blocks=1024, block_size=16, decode_width=16,
               prefill_chunk=64, prefix_cache=True)
GEN_REQUESTS = 32
GEN_SEED = 4321
# paged kernel against its plain version: the same fp32 arithmetic summed
# in another order (and q scaled before the dot, as the TPU kernel does)
PAGED_TOL = (1e-5, 1e-5)
# paged step against full recompute, and the card against the CPU port:
# 16 layers of fp32 in other orders, logits O(1)
GEN_TOL = dict(atol=1e-3, rtol=1e-3)
# int8 KV against fp32: tests/test_quantized_serving.py's budget
INT8_MAX_ABS, INT8_MSE = 0.25, 5e-3
# pool rows no real query may see hold this (finite: 0 * NaN would
# poison the plain version too)
GARBAGE = 1e4
# (kv dtype, Cq, bs, D) of the parity cases
PAGED_CASES = tuple((kv, cq, bs, d) for kv in ("fp32", "int8", "fp8")
                    for cq in (1, 4) for bs in (16, 32)
                    for d in (16, 64, 128, 256))
# rows of up to 40 blocks of 16 (640 positions): past the kernel's staged
# chunk of positions (kChunk), so a CTA stages more than once
PAGED_LONG_CASES = tuple((kv, cq, 16, 64) for kv in ("fp32", "int8", "fp8")
                         for cq in (1, 4))
PAGED_LONG_BLOCKS = 40


def paged_case(kv, cq, bs, d, device, seed, heads=4, max_blocks=8,
               num_blocks=80):
    """Inputs of one parity case: rows of ragged q_lens and ctx_lens (a
    decode single, a full chunk crossing a block boundary, a short chunk
    at ctx 0, a row with no query, an idle row on the trash block at
    position 0), private block tables, and pools whose every row that no
    real query sees holds GARBAGE. Returns (args, kwargs, q_lens)."""
    from paddle_tpu_torch import quant
    rng = np.random.default_rng(seed)
    span = max_blocks * bs
    if cq == 1:
        q_lens = [1, 1, 1, 1, 1, 1]
        ctx = [span - 1, bs - 1, bs, 0, 3 * bs + 5, 0]
    else:
        q_lens = [cq, 1, cq - 1, 0, cq, 1]
        ctx = [bs - 2, span - 1, 0, 7, 2 * bs - 1, 0]
    b = len(q_lens)
    free = rng.permutation(np.arange(1, num_blocks))
    tables = free[:b * max_blocks].reshape(b, max_blocks).astype(np.int32)
    tables[-1] = 0                           # the idle row: all trash
    seen = np.zeros((num_blocks, bs), bool)
    for r in range(b):
        for p in range(ctx[r] + q_lens[r]):
            seen[tables[r, p // bs], p % bs] = True
    shape = (num_blocks, bs, heads, d)
    q = rng.standard_normal((b, cq, heads, d)).astype(np.float32)
    pools, scales = [], []
    for _ in range(2):
        x = rng.standard_normal(shape).astype(np.float32)
        x[~seen] = GARBAGE
        t = torch.from_numpy(x)
        if kv == "fp32":
            pools.append(t.to(device))
            continue
        stored, s = quant.quantize_kv_rows(t, quant.storage_dtype(kv))
        s[~torch.from_numpy(seen)] = GARBAGE
        pools.append(stored.to(device))
        scales.append(s.to(device))
    args = (torch.from_numpy(q).to(device), pools[0], pools[1],
            torch.from_numpy(tables).to(device),
            torch.tensor(q_lens, dtype=torch.int32, device=device),
            torch.tensor(ctx, dtype=torch.int32, device=device))
    kwargs = {} if kv == "fp32" else dict(k_scales=scales[0],
                                          v_scales=scales[1])
    return args, kwargs, q_lens


def check_paged(device):
    """Both paged kernels against the plain version on the card, every
    PAGED_CASES shape and the long rows of PAGED_LONG_CASES: real query
    rows within PAGED_TOL, rows with no query exactly 0. Returns the
    worst error per pool dtype."""
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.kernels import paged_attention as PA
    worst = {}
    cases = [(c, 8, 80) for c in PAGED_CASES] + [
        (c, PAGED_LONG_BLOCKS, 6 * PAGED_LONG_BLOCKS + 1)
        for c in PAGED_LONG_CASES]
    for i, ((kv, cq, bs, d), max_blocks, num_blocks) in enumerate(cases):
        if kv == "fp8" and not quant.supports_fp8():
            fail("fp8 KV: torch.float8_e4m3fn does not convert exactly")
        args, kwargs, q_lens = paged_case(kv, cq, bs, d, device, 700 + i,
                                          max_blocks=max_blocks,
                                          num_blocks=num_blocks)
        scale = 1.0 / math.sqrt(d)
        got = PA._launch(*args, scale, **kwargs)
        torch.cuda.synchronize()
        want = PA.ragged_paged_attention_reference(*args, scale, **kwargs)
        what = f"paged {kv} Cq={cq} bs={bs} D={d} M={max_blocks}"
        errs = []
        for r, n in enumerate(q_lens):
            if n:
                err, ok = max_err(got[r, :n], want[r, :n], *PAGED_TOL)
                errs.append(err)
                if not ok:
                    fail(f"{what} row {r}: max error {err} beyond "
                         f"{PAGED_TOL}")
            if n < cq and got[r, n:].abs().max().item() != 0.0:
                fail(f"{what} row {r}: rows with no query must give 0")
        worst[kv] = max(worst.get(kv, 0.0), max(errs))
        say("parity", f"{what} q_lens={q_lens}: max error {max(errs):.3e} "
            f"(tol {PAGED_TOL[0]:g} + {PAGED_TOL[1]:g}|ref|), unused rows 0;"
            " ok")
    say("parity", "paged_attention worst error by pool: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def gen_requests(cfg, n=GEN_REQUESTS, seed=GEN_SEED, prefix=256,
                 lo=16, hi=448, new_lo=32, new_hi=64):
    """The main path's requests: prompts of lo..hi tokens from a numpy
    seed, max_new_tokens new_lo..new_hi capped at max_seq_len; even ones
    greedy, odd ones temperature 0.8 with top_k 40 or top_p 0.95 and their
    own seeds; requests 0, n/2, 3n/4 and n-1 share a ``prefix``-token
    prefix (the later three are admitted after the first has published
    it: prefix-cache hits)."""
    from paddle_tpu_torch.generation import GenerationRequest, SamplingParams
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, prefix).tolist()
    sharers = {0, n // 2, 3 * n // 4, n - 1}
    reqs = []
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        if i in sharers:
            length = max(length, prefix + 8)
            prompt = shared + rng.integers(0, cfg.vocab_size,
                                           length - prefix).tolist()
        else:
            prompt = rng.integers(0, cfg.vocab_size, length).tolist()
        new = min(int(rng.integers(new_lo, new_hi + 1)),
                  cfg.max_seq_len - length)
        if i % 2 == 0:
            sp = SamplingParams()
        elif i % 4 == 1:
            sp = SamplingParams(temperature=0.8, top_k=40, seed=1000 + i)
        else:
            sp = SamplingParams(temperature=0.8, top_p=0.95, seed=1000 + i)
        reqs.append(GenerationRequest(prompt=prompt, max_new_tokens=new,
                                      sampling=sp, request_id=i))
    return reqs


def gen_counts():
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.kernels import paged_attention as PA
    return dict(paged=PA.launches, paged_quant=PA.launches_quant,
                layer_norm=LN.launches)


def serve_generation(engine, reqs, label,
                     step_timer="TIMER_generation_mixed_step_us"):
    """The main path: ``reqs`` through a GenerationPool over ``engine``.
    Launch counts, the path log and the monitor are set to 0 just before
    and read just after; a model drafter's calls are counted. Returns
    (streams, record); ``step_timer`` names the engine's step (the
    two-phase engine's is the decode step)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.generation import GenerationPool
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.kernels import paged_attention as PA
    torch.cuda.synchronize()
    draft_calls = [0]
    if engine.draft_params is not None:
        real_draft = engine._run_draft

        def counted(*a):
            draft_calls[0] += 1
            return real_draft(*a)
        engine._run_draft = counted
    PA.launches = PA.launches_quant = LN.launches = 0
    PA.reset_path_log()
    monitor.reset_all()
    t0 = time.perf_counter()
    try:
        with GenerationPool(engine) as pool:
            futs = [pool.submit(r) for r in reqs]
            results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
    finally:
        if engine.draft_params is not None:
            engine._run_draft = real_draft
    wall = time.perf_counter() - t0
    rec = dict(counts=gen_counts(), paths=PA.paths_taken(), wall=wall,
               steps=int(monitor.timer_get(step_timer)["count"]),
               step_us=monitor.timer_get(step_timer),
               ttft_us=monitor.timer_get("TIMER_generation_ttft_us"),
               tpot_us=monitor.timer_get("TIMER_generation_tpot_us"),
               prefill_us=monitor.timer_get("TIMER_generation_prefill_us"),
               draft_calls=draft_calls[0],
               stats={k: monitor.stat_get(f"STAT_generation_{k}") for k in
                      ("tokens", "prefills", "prefix_hits",
                       "prefix_hit_tokens", "prefix_cow_copies",
                       "evictions", "pad_tokens", "spec_proposed",
                       "spec_accepted", "draft_faults")})
    streams = {r.request_id: r.tokens for r in results}
    say("generate", f"{label}: {len(reqs)} requests through GenerationPool "
        f"in {wall:.2f} s, {rec['steps']} steps; " + ", ".join(
            f"{k} {v:g}" for k, v in rec["stats"].items()) +
        (f", draft calls {draft_calls[0]}" if draft_calls[0] else ""))
    if engine.last_draft_fault is not None:
        fail(f"{label}: the drafter raised {engine.last_draft_fault!r}")
    return streams, rec


def check_gen_launches(rec, cfg, kv, label, prefills=0, draft_layers=0):
    """Paged-kernel launches = layers x steps (the kernel of the pool's
    dtype, none of the other) + the drafter's layers x its calls,
    layer-norm launches = (2 layers + 1) x (steps + two-phase prefills) +
    (2 draft layers + 1) x draft calls, an all-"cuda" path log of one entry
    a launch."""
    c, steps, calls = rec["counts"], rec["steps"], rec["draft_calls"]
    which, other = ("paged", "paged_quant") if kv == "fp32" else \
        ("paged_quant", "paged")
    want = cfg.layers * steps + draft_layers * calls
    if steps == 0 or c[which] != want or c[other] != 0:
        fail(f"{label}: paged launches {c} after {steps} steps and {calls} "
             f"draft calls, want {which} = {want}")
    want_ln = (2 * cfg.layers + 1) * (steps + prefills) + \
        (2 * draft_layers + 1) * calls
    if c["layer_norm"] != want_ln:
        fail(f"{label}: layer_norm launches {c['layer_norm']}, want "
             f"{2 * cfg.layers + 1} x ({steps} steps + {prefills} prefills)"
             f" + {2 * draft_layers + 1} x {calls} draft calls = {want_ln}")
    if set(rec["paths"]) != {"cuda"} or len(rec["paths"]) != want:
        fail(f"{label}: paged path log {sorted(set(rec['paths']))} x "
             f"{len(rec['paths'])}, want 'cuda' x {want}")
    say("generate", f"{label}: {c[which]} {which} launches = {cfg.layers} "
        f"x {steps} steps" + (f" + {draft_layers} x {calls} draft calls"
                              if calls else "") +
        f", {c['layer_norm']} layer_norm launches = {2 * cfg.layers + 1} x "
        f"{steps + prefills} ({steps} steps" +
        (f" + {prefills} prefills" if prefills else "") + ")" +
        (f" + {2 * draft_layers + 1} x {calls}" if calls else "") +
        f", path log {len(rec['paths'])} x 'cuda'")


def check_gen_outputs(streams, reqs, cfg, label):
    for r in reqs:
        toks = streams.get(r.request_id)
        if toks is None or len(toks) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{label}: request {r.request_id} gave {toks!r}")
    say("generate", f"{label}: every request gave max_new_tokens tokens "
        "inside the vocabulary")


def capture_steps(engine):
    """Wrap the engine's forward_paged to keep, for every sampled slot of
    every step, (request id, position, logits row): a decode slot, or the
    last slot of a prompt's final chunk. Returns (records, undo)."""
    import paddle_tpu_torch.generation.engine as E
    real = E.forward_paged
    records = []

    def wrapped(cfg, params, kp, vp, tables, positions, tokens, **kw):
        logits = real(cfg, params, kp, vp, tables, positions, tokens, **kw)
        owner = {int(engine._tables[ln][0]): s for ln, s in
                 enumerate(engine._lane_seq) if s is not None}
        first = tables[:, 0].cpu().tolist()
        pos = positions.cpu().tolist()
        for slot, (blk, p) in enumerate(zip(first, pos)):
            seq = owner.get(blk)
            if seq is not None and p + 1 >= len(seq.req.prompt):
                records.append((seq.req.request_id, p, logits[slot].clone()))
        return logits
    E.forward_paged = wrapped

    def undo():
        E.forward_paged = real
    return records, undo


def check_recompute(cfg, params, device, kv, reqs, label="", **engine_kw):
    """Paged against full recompute on the card: ``reqs`` through a
    fresh engine (prefix cache off, so a table's first block names its
    request; ``engine_kw`` on top of GEN_GEO), every sampled slot's logits
    against forward_full over the same context. fp32 pools: within
    GEN_TOL, and every greedy token the recompute's argmax or within 1e-3
    of its maximum. int8 pools: within the reference's int8 budget against
    the fp32 recompute."""
    from paddle_tpu_torch.generation import GenerationEngine, forward_full
    eng = GenerationEngine(cfg, params, kv_dtype=kv, device=device,
                           **dict(GEN_GEO, prefix_cache=False, **engine_kw))
    records, undo = capture_steps(eng)
    try:
        res = {r.request_id: r for r in eng.generate(reqs)}
    finally:
        undo()
    seqs = {r.request_id: list(r.prompt) + res[r.request_id].tokens
            for r in reqs}
    greedy = {r.request_id for r in reqs if r.sampling.temperature <= 0}
    worst, sq, n, exact, ties = 0.0, 0.0, 0, 0, 0
    for rid, p, row in records:
        ctx = seqs[rid][:p + 1]
        full = forward_full(cfg, eng.params, torch.tensor([ctx],
                                                          device=device),
                            torch.tensor([len(ctx)], device=device),
                            attn_lanes=eng.attn_lanes)[0][0]
        diff = (row - full).abs()
        worst = max(worst, float(diff.max()))
        sq += float((diff.double() ** 2).sum())
        n += diff.numel()
        if kv == "fp32":
            err, ok = max_err(row, full, **GEN_TOL)
            if not ok:
                fail(f"recompute: request {rid} position {p}: paged logits "
                     f"differ from forward_full by {err}")
            if rid in greedy and p + 1 < len(seqs[rid]):
                tok = seqs[rid][p + 1]
                top = float(full.max())
                if tok == int(full.argmax()):
                    exact += 1
                elif top - float(full[tok]) <= 1e-3:
                    ties += 1
                else:
                    fail(f"recompute: greedy token {tok} of request {rid} "
                         f"at {p + 1} is {top - float(full[tok])} below the "
                         "recompute's maximum")
    mse = sq / max(n, 1)
    if kv == "fp32":
        say("generate", f"{label}paged vs full recompute, fp32 KV, "
            f"{len(records)} "
            f"sampled slots of {len(reqs)} requests: max |diff| {worst:.3e} "
            f"(tol {GEN_TOL['atol']:g} + {GEN_TOL['rtol']:g}|ref|); greedy "
            f"tokens {exact} exact argmax, {ties} near ties (share exact "
            f"{exact / max(exact + ties, 1):.4f})")
    else:
        if worst >= INT8_MAX_ABS or mse >= INT8_MSE:
            fail(f"int8 KV: logits max |diff| {worst}, MSE {mse} against "
                 f"fp32 recompute (budget {INT8_MAX_ABS}, {INT8_MSE})")
        say("generate", f"int8 KV vs fp32 recompute, {len(records)} sampled "
            f"slots: max |diff| {worst:.4f} (budget {INT8_MAX_ABS}), MSE "
            f"{mse:.3e} (budget {INT8_MSE:g})")
    del eng
    torch.cuda.empty_cache()
    return worst


def step_case(cfg, num_blocks, seed, decode=16, chunk=64, chunk_start=128,
              decode_ctx=(20, 200)):
    """One mixed step of ``decode`` + ``chunk`` slots (the main path's 80)
    over pools of random content: decode rows with private tables at
    positions drawn from ``decode_ctx``, a chunk of one prompt at
    ``chunk_start``. Every written row is distinct. Returns numpy
    (tables, positions, tokens), the pools' shape and the written (block,
    offset) pairs."""
    rng = np.random.default_rng(seed)
    bs = GEN_GEO["block_size"]
    m = -(-cfg.max_seq_len // bs)
    blocks = iter(rng.permutation(np.arange(1, num_blocks)).tolist())
    t = decode + chunk
    tables = np.zeros((t, m), np.int32)
    positions = np.zeros(t, np.int32)
    for r in range(decode):
        p = int(rng.integers(*decode_ctx))
        tables[r, :p // bs + 1] = [next(blocks) for _ in range(p // bs + 1)]
        positions[r] = p
    last = chunk_start + chunk - 1
    row = [next(blocks) for _ in range(last // bs + 1)]
    for j in range(chunk):
        tables[decode + j, :len(row)] = row
        positions[decode + j] = chunk_start + j
    tokens = rng.integers(0, cfg.vocab_size, t).astype(np.int32)
    written = [(int(tables[i, positions[i] // bs]), int(positions[i] % bs))
               for i in range(t)]
    shape = (cfg.layers, num_blocks, bs, cfg.heads, cfg.head_dim)
    return (tables, positions, tokens), shape, written


def check_step_vs_cpu(cfg, params_np, device, kv="fp32", num_blocks=256,
                      weights="fp32"):
    """One mixed step at full width on the card (kernels) against the same
    step on the CPU port (plain versions), from the same pools: logits and
    every written pool row within GEN_TOL.

    With ``kv`` int8/fp8 the pools hold quantized random rows beside their
    scale pools and the step runs the quantized kernel. An fp32 difference
    of 1e-6 in K or V can carry a value across a rounding boundary, and
    one code step then moves the logits by ~1e-3. So the CPU step stores
    the card's quantized rows in place of its own: both sides attend over
    the same payloads, the written rows must agree exactly, and the CPU's
    own codes must lie within one step of the card's (their count is
    printed).

    With ``weights`` "int8" the parameters are ``quantize_decoder_params``
    of ``params_np`` and every matmul quantizes its activations per row
    (``quant.qmatmul``): the same rounding boundaries, one activation code
    a step of absmax / 127 of its row. So the CPU step takes the card's
    activation codes and steps in place of its own too: the int32
    products are then exact on both sides (``torch._int_mm`` on the card,
    a float64 product on the CPU), what is left is fp32 arithmetic in
    other orders, and GEN_TOL holds; the CPU's own codes must again lie
    within one step of the card's."""
    import paddle_tpu_torch.generation.model as M
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.jit import load_reference_params
    if weights != "fp32":
        params_np = quant.quantize_decoder_params(params_np, weights)
    inputs, shape, written = step_case(cfg, num_blocks, GEN_SEED + 7)
    rng = np.random.default_rng(GEN_SEED + 8)
    pools = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
             for _ in range(2)]
    scales = []
    if kv != "fp32":
        pools, scales = zip(*(quant.quantize_kv_rows(
            p, quant.storage_dtype(kv)) for p in pools))
    blk = torch.tensor([w[0] for w in written])
    off = torch.tensor([w[1] for w in written])
    real_q = M.quantize_kv_rows
    real_a = quant._quantize_rows
    card_rows, own_rows, card_acts, own_acts = [], [], [], []

    def on_card(x, dtype):
        q, sc = real_q(x, dtype)
        card_rows.append((q.cpu(), sc.cpu()))
        return q, sc

    def on_cpu(x, dtype):
        own_rows.append(real_q(x, dtype))
        return card_rows[len(own_rows) - 1]

    def acts_on_card(x):
        xq, xs = real_a(x)
        card_acts.append((xq.cpu(), xs.cpu()))
        return xq, xs

    def acts_on_cpu(x):
        own_acts.append(real_a(x))
        return card_acts[len(own_acts) - 1]
    out = []
    try:
        for where, hook, acts in ((device, on_card, acts_on_card),
                                  (torch.device("cpu"), on_cpu,
                                   acts_on_cpu)):
            M.quantize_kv_rows = hook
            quant._quantize_rows = acts
            params = load_reference_params(cfg, params_np, where)
            kp, vp = (p.to(where, copy=True) for p in pools)
            sc = [s.to(where, copy=True) for s in scales]
            logits = M.forward_paged(cfg, params, kp, vp,
                                     *(torch.from_numpy(a).to(where)
                                       for a in inputs), *sc)
            idx = (slice(None), blk.to(where), off.to(where))
            out.append([logits.cpu()] + [t[idx].cpu()
                                         for t in (kp, vp, *sc)])
            del params, kp, vp, sc
    finally:
        M.quantize_kv_rows = real_q
        quant._quantize_rows = real_a
    parts = []
    names = ("logits", "written K", "written V", "written K scales",
             "written V scales")
    for what, g, c in zip(names, *out):
        if g.dtype != torch.float32:
            ok, err = torch.equal(g.view(torch.int8), c.view(torch.int8)), \
                float((g.float() - c.float()).abs().max())
        elif what.endswith("scales"):
            ok, err = torch.equal(g, c), float((g - c).abs().max())
        else:
            err, ok = max_err(g, c, **GEN_TOL)
        parts.append(f"{what} {err:.3e}")
        if not ok:
            fail(f"mixed step {kv} KV, card vs CPU port: {what} differ by "
                 f"{err}")
    if kv != "fp32":
        diffs = [(q.float() - cq.float()).abs()
                 for (q, _), (cq, _) in zip(own_rows, card_rows)]
        flips = sum(int((d > 0).sum()) for d in diffs)
        worst = max(float(d.max()) for d in diffs)
        if kv == "int8" and worst > 1:
            fail(f"mixed step int8 KV: the CPU's own codes lie {worst} "
                 "steps from the card's")
        parts.append(f"the CPU's own codes differ from the card's at {flips}"
                     f" of {sum(d.numel() for d in diffs)} (by at most "
                     f"{worst:g})")
    if weights != "fp32":
        if len(own_acts) != len(card_acts) or not card_acts:
            fail(f"mixed step {weights} weights: {len(card_acts)} quantized "
                 f"matmuls on the card, {len(own_acts)} on the CPU")
        diffs = [(q.float() - cq.float()).abs()
                 for (q, _), (cq, _) in zip(own_acts, card_acts)]
        flips = sum(int((d > 0).sum()) for d in diffs)
        worst = max(float(d.max()) for d in diffs)
        if worst > 1:
            fail(f"mixed step {weights} weights: the CPU's own activation "
                 f"codes lie {worst} steps from the card's")
        parts.append(f"{len(card_acts)} quantized matmuls, the CPU's own "
                     f"activation codes differ from the card's at {flips} of "
                     f"{sum(d.numel() for d in diffs)} (by at most "
                     f"{worst:g})")
    say("generate", f"one mixed step of {len(written)} slots at full width, "
        f"{kv} KV, {weights} weights, card (kernels) vs CPU port (plain "
        "versions): " +
        ", ".join(parts) + f" (tol {GEN_TOL['atol']:g} + "
        f"{GEN_TOL['rtol']:g}|ref|" +
        ("" if kv == "fp32" else "; written rows exact") + ")")


def paged_bench_case(device, kv, seed, decode=16, chunk=64, ctx=256,
                     heads=16, d=64, bs=16, num_blocks=1024, max_blocks=32):
    """The main path's representative paged call: ``decode`` rows each at
    position ``ctx`` of its own sequence, and ``chunk`` rows of one prompt
    at positions ctx - chunk .. ctx - 1 (sharing one table). Returns
    (args, kwargs, unique bytes, bytes with re-reads)."""
    from paddle_tpu_torch import quant
    rng = np.random.default_rng(seed)
    blocks = iter(rng.permutation(np.arange(1, num_blocks)).tolist())
    b = decode + chunk
    tables = np.zeros((b, max_blocks), np.int32)
    positions = np.zeros(b, np.int32)
    per = ctx // bs + 1
    for r in range(decode):
        tables[r, :per] = [next(blocks) for _ in range(per)]
        positions[r] = ctx
    prompt = [next(blocks) for _ in range(ctx // bs)]
    for j in range(chunk):
        tables[decode + j, :len(prompt)] = prompt
        positions[decode + j] = ctx - chunk + j
    shape = (num_blocks, bs, heads, d)
    esz = {"fp32": 4, "int8": 1, "fp8": 1}[kv]
    # bytes a visible position costs: its K and V rows, and their scales
    row = 2 * heads * d * esz + (0 if kv == "fp32" else 2 * heads * 4)
    seen = {(int(tables[r, p // bs]), p % bs) for r in range(b)
            for p in range(positions[r] + 1)}
    reread = int((positions + 1).sum())
    qo = 2 * b * heads * d * 4
    pools, scales = [], []
    for i in range(2):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(
            seed + 7 * i))
        if kv == "fp32":
            pools.append(x.to(device))
        else:
            stored, s = quant.quantize_kv_rows(x, quant.storage_dtype(kv))
            pools.append(stored.to(device))
            scales.append(s.to(device))
    q = torch.randn(b, 1, heads, d, generator=torch.Generator()
                    .manual_seed(seed + 1)).to(device)
    args = (q, pools[0], pools[1], torch.from_numpy(tables).to(device),
            torch.ones(b, dtype=torch.int32, device=device),
            torch.from_numpy(positions).to(device))
    kwargs = {} if kv == "fp32" else dict(k_scales=scales[0],
                                          v_scales=scales[1])
    return args, kwargs, len(seen) * row + qo, reread * row + qo


def sdpa_paged(q, k_pool, v_pool, tables, q_lens, ctx, k_scales=None,
               v_scales=None):
    """The library yardstick: gather K/V through the table (dequantized
    for int8/fp8 pools) and F.scaled_dot_product_attention with the
    boolean mask. Timed only; the port never calls it."""
    from paddle_tpu_torch.kernels.paged_attention import _gather
    tbl = tables.long()
    k = _gather(k_pool, k_scales, tbl).float()
    v = _gather(v_pool, v_scales, tbl).float()
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, :] <= ctx.long()[:, None])[:, None, None, :]
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask)
    return o.transpose(1, 2)


def time_paged(device, card):
    """Each pool dtype at the representative shape: the kernel held
    against its plain version on every input set (PAGED_TOL; every row is
    real), then kernel, plain version and the SDPA yardstick timed, device
    ms per call from a CUDA graph over enough input sets to pass the L2
    cache; the bound from the unique visible bytes at 3.35 TB/s (the
    re-read bytes beside it)."""
    from paddle_tpu_torch.kernels import paged_attention as PA
    records = {}
    for kv in ("fp32", "int8", "fp8"):
        first = paged_bench_case(device, kv, 900)
        sets = copies(lambda i: first if i == 0 else
                      paged_bench_case(device, kv, 900 + i), first[2])
        scale = 1.0 / math.sqrt(64)
        worst = 0.0
        for s in sets:
            got = PA._launch(*s[0], scale, **s[1])
            want = PA.ragged_paged_attention_reference(*s[0], scale, **s[1])
            err, ok = max_err(got, want, *PAGED_TOL)
            worst = max(worst, err)
            if not ok:
                fail(f"paged {kv} at the main path's shape: max error {err} "
                     f"beyond {PAGED_TOL}")
        say("parity", f"paged_attention {kv} pools at the main path's shape "
            f"(80 slots, H 16, D 64, bs 16, M 32, N 1024), {len(sets)} input "
            f"sets: max error {worst:.3e} (tol {PAGED_TOL[0]:g} + "
            f"{PAGED_TOL[1]:g}|ref|); ok")
        kern = [lambda s=s: PA._launch(*s[0], scale, **s[1]) for s in sets]
        plain = [lambda s=s: PA.ragged_paged_attention_reference(
            *s[0], scale, **s[1]) for s in sets]
        lib = [lambda s=s: sdpa_paged(*s[0], **s[1]) for s in sets]
        ms = device_ms(kern)
        plain_ms = device_ms(plain, reps=2)
        lib_ms = device_ms(lib, reps=2)
        # the kernel does 4 D flops a visible key and head: far below the
        # bytes' time at 67 TFLOP/s
        nbytes, reread = first[2], first[3]
        flops = 4 * 64 * 16 * int((first[0][5].long() + 1).sum())
        bms, by = bound_ms(nbytes, flops, torch.float32)
        records[kv] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bms, bound_by=by, bytes=nbytes,
                           reread_bytes=reread, max_abs_err=worst)
        say("times", f"paged_attention {kv} pools, 80 slots (16 decode at "
            f"ctx 256, a 64-token chunk at 192..255), H 16, D 64, bs 16, "
            f"{len(sets)} input sets: "
            f"kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f}"
            f" MB unique; {reread / 1e6:.1f} MB with the chunk's re-reads, "
            f"{reread / HBM_BYTES_PER_S * 1e3:.4f} ms), plain {plain_ms:.4f} "
            f"ms, gather + SDPA {lib_ms:.4f} ms  [{card}]")
        del first, sets, kern, plain, lib
        torch.cuda.empty_cache()
    return records


KERNEL_TIME_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
GEN_GROUPS = (("paged attention", ("ragged_paged",)),
              ("layer norm", ("layer_norm_fwd",)),
              ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")))


def profile_generation(engine, reqs, kv, card, warm=6, window=12):
    """Device busy time and idle share over a window of mixed steps in
    steady state (decode lanes and prefill chunks together): requests go
    straight into the engine, ``warm`` steps run, then ``window`` steps
    under torch.profiler; busy is the summed kernel durations, the wall
    time is the host clock around the window. The engine is left
    mid-run: the caller drops it."""
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        engine.submit(r)
    for _ in range(warm):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = {g: 0.0 for g, _ in GEN_GROUPS}
    groups["other"] = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = next((g for g, keys in GEN_GROUPS if any(k in e.name
                                                     for k in keys)),
                 "other")
        groups[g] += e.time_range.elapsed_us() / 1e3
    busy = sum(groups.values())
    idle = max(0.0, 1.0 - busy / wall) if busy > 0 else float("nan")
    say("times", f"{kv} KV, {window} mixed steps in steady state: wall "
        f"{wall:.2f} ms ({wall / window:.2f} ms a step), device busy "
        f"{busy:.2f} ms, idle share {idle:.3f}; " + ", ".join(
            f"{g} {t:.2f} ms" for g, t in groups.items()) + "; paged "
        f"attention {groups['paged attention'] / window:.4f} ms a mixed "
        f"step  [{card}]")
    return dict(wall_ms=wall, busy_ms=busy, idle=idle,
                paged_ms_per_step=groups["paged attention"] / window)


def gen_times(rec, label, card):
    tokens = rec["stats"]["tokens"]
    us = {k: rec[k] for k in ("step_us", "ttft_us", "tpot_us")}
    say("times", f"generation {label}: {tokens:g} tokens in "
        f"{rec['wall']:.2f} s, {tokens / rec['wall']:.1f} generated "
        f"tokens/s; step p50 {us['step_us']['p50'] / 1e3:.2f} ms, p95 "
        f"{us['step_us']['p95'] / 1e3:.2f} ms ({rec['steps']} steps); TTFT "
        f"p50 {us['ttft_us']['p50'] / 1e3:.1f} ms, p95 "
        f"{us['ttft_us']['p95'] / 1e3:.1f} ms; TPOT p50 "
        f"{us['tpot_us']['p50'] / 1e3:.2f} ms, p95 "
        f"{us['tpot_us']['p95'] / 1e3:.2f} ms  [{card}]")


# a difference between two engines' streams is a near tie when, at the
# first token where they part, both tokens score within this of the best
# score of the full recompute (check_recompute's rule for greedy tokens; a
# sampled row's scores are the filtered logits / T plus its Gumbel noise,
# so the margin there is this / T)
NEAR_TIE = 1e-3
# speculative decoding at the main path's geometry: k drafts a lane
SPEC_K = 4
# the model drafter is the target itself: its greedy drafts are the
# target's greedy tokens but where the two steps' logits (other slot
# counts, so other cuBLAS kernels) part at a near tie
DRAFT_ACCEPT_MIN = 0.9


def sampler_scores(full, sp, step):
    """What a request's sampler ranks at token index ``step``: the logits
    (greedy), or the filtered logits / T plus the Gumbel noise of (seed,
    step), in float64."""
    from paddle_tpu_torch.generation import sampling as S
    z = full.float()[None]
    if sp.temperature <= 0:
        return z[0].double()
    dev = z.device
    f = S.filter_logits(z, torch.tensor([sp.temperature], device=dev),
                        torch.tensor([sp.top_k], device=dev),
                        torch.tensor([sp.top_p], device=dev))
    g = S._gumbel_noise(torch.tensor([sp.seed], device=dev),
                        torch.tensor([step], device=dev), z.shape[-1])
    return (f.double() + g)[0]


def check_same_streams(cfg, params, device, reqs, got, want, label,
                       attn_lanes):
    """``got`` against ``want`` (two engines on the same requests): each
    stream equal, or equal up to the first token where they part, which
    must be a near tie of the full recompute over the shared context
    (NEAR_TIE). Returns (equal, near ties)."""
    from paddle_tpu_torch.generation import forward_full
    equal = ties = 0
    for r in reqs:
        a, b = got[r.request_id], want[r.request_id]
        if a == b:
            equal += 1
            continue
        p = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if p is None:
            fail(f"{label}: request {r.request_id} gave {len(a)} tokens "
                 f"against {len(b)}")
        ctx = list(r.prompt) + b[:p]
        full = forward_full(cfg, params, torch.tensor([ctx], device=device),
                            torch.tensor([len(ctx)], device=device),
                            attn_lanes=attn_lanes)[0][0]
        sc = sampler_scores(full, r.sampling, p)
        tol = NEAR_TIE / (r.sampling.temperature
                          if r.sampling.temperature > 0 else 1.0)
        top = float(sc.max())
        gaps = (top - float(sc[a[p]]), top - float(sc[b[p]]))
        if max(gaps) > tol:
            fail(f"{label}: request {r.request_id} parts at token {p} "
                 f"({a[p]} against {b[p]}), {max(gaps)} below the "
                 f"recompute's best score (near tie {tol:g})")
        ties += 1
    say("generate", f"{label}: {equal} of {len(reqs)} streams equal, {ties} "
        f"part at a near tie of the recompute (within {NEAR_TIE:g} of its "
        "best score, / T for a sampled row)")
    return equal, ties


def pattern_requests(cfg, n, seed, greedy=False, new_lo=32, new_hi=64):
    """Prompts of a repeated 16-token pattern (2-12 repeats, cut mid-way),
    from a numpy seed, so the ngram drafter finds matches; sampling as
    gen_requests (or all greedy)."""
    from paddle_tpu_torch.generation import GenerationRequest, SamplingParams
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        pat = rng.integers(0, cfg.vocab_size, 16).tolist()
        reps = int(rng.integers(2, 13))
        prompt = (pat * reps)[:16 * reps - int(rng.integers(0, 16))]
        new = int(rng.integers(new_lo, new_hi + 1))
        if greedy or i % 2 == 0:
            sp = SamplingParams()
        elif i % 4 == 1:
            sp = SamplingParams(temperature=0.8, top_k=40, seed=2000 + i)
        else:
            sp = SamplingParams(temperature=0.8, top_p=0.95, seed=2000 + i)
        reqs.append(GenerationRequest(prompt=prompt, max_new_tokens=new,
                                      sampling=sp, request_id=i))
    return reqs


def run_two_phase(cfg, params, device, card, reqs, chunked, few):
    """(i) The two-phase engine (prefill_chunk=0, the pow2:512 ladder) on
    the main path's requests: launches (16 paged and 33 layer-norm a decode
    step, 33 layer-norm and no paged a prefill), its streams against the
    chunked engine's (``chunked``: streams, record), its decode logits
    against full recompute, its times beside the chunked engine's."""
    from paddle_tpu_torch.generation import GenerationEngine
    eng = GenerationEngine(cfg, params, kv_dtype="fp32", device=device,
                           **dict(GEN_GEO, prefill_chunk=0))
    t0 = time.perf_counter()
    report = eng.warmup()
    say("generate", f"(i) two-phase engine: ladder {eng.prefill_ladder}, "
        f"{eng.decode_width} lanes; warmup (the decode step, every prefill "
        f"rung) {time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in report.items()))
    label = "(i) two-phase, fp32 KV"
    streams, rec = serve_generation(
        eng, reqs, label, step_timer="TIMER_generation_decode_step_us")
    prefills = int(rec["stats"]["prefills"])
    if prefills < len(reqs):
        fail(f"{label}: {prefills} prefills for {len(reqs)} requests")
    check_gen_launches(rec, cfg, "fp32", label, prefills=prefills)
    check_gen_outputs(streams, reqs, cfg, label)
    check_same_streams(cfg, eng.params, device, reqs, streams, chunked[0],
                       f"{label} vs chunked", eng.attn_lanes)
    del eng
    torch.cuda.empty_cache()
    check_recompute(cfg, params, device, "fp32", few, "(i) two-phase: ",
                    prefill_chunk=0)
    gen_times(rec, "two-phase fp32 KV (decode step)", card)
    gen_times(chunked[1], "chunked fp32 KV (mixed step), beside it", card)
    pre = rec["prefill_us"]
    say("times", f"generation two-phase: {prefills} prefills, p50 "
        f"{pre['p50'] / 1e3:.2f} ms, p95 {pre['p95'] / 1e3:.2f} ms (bucketed "
        "forward_full, the pool write and the first token)  [" + card + "]")
    return rec


def run_spec(cfg, params, device, card, n_ngram=16, n_model=8):
    """(ii) the ngram drafter and (iii) the model drafter (the target
    itself), k = SPEC_K, each against the plain chunked engine on the same
    requests: launches (the drafter's pools counted apart), proposals,
    acceptances, no draft fault, streams under the near-tie rule, times."""
    from paddle_tpu_torch.generation import GenerationEngine
    recs = {}
    cases = (
        ("(ii) ngram drafter", pattern_requests(cfg, n_ngram, GEN_SEED + 20),
         {}, dict(GEN_GEO)),
        ("(iii) model drafter = the target",
         pattern_requests(cfg, n_model, GEN_SEED + 30, greedy=True,
                          new_lo=32, new_hi=48),
         dict(draft="model", draft_cfg=cfg, draft_params=params),
         dict(GEN_GEO, prefix_cache=False)))
    for label, reqs, draft, geo in cases:
        plain = GenerationEngine(cfg, params, device=device, **geo)
        want, prec = serve_generation(plain, reqs, f"{label}: plain engine")
        check_gen_launches(prec, cfg, "fp32", f"{label}: plain engine")
        del plain
        eng = GenerationEngine(cfg, params, device=device,
                               spec_tokens=SPEC_K, **draft, **geo)
        eng.warmup()
        name = f"{label}, k={SPEC_K}"
        got, rec = serve_generation(eng, reqs, name)
        st = rec["stats"]
        check_gen_launches(rec, cfg, "fp32", name,
                           draft_layers=cfg.layers if draft else 0)
        check_gen_outputs(got, reqs, cfg, name)
        if st["spec_proposed"] <= 0 or st["draft_faults"] != 0:
            fail(f"{name}: proposed {st['spec_proposed']}, draft faults "
                 f"{st['draft_faults']}")
        rate = st["spec_accepted"] / st["spec_proposed"]
        if draft and rate <= DRAFT_ACCEPT_MIN:
            fail(f"{name}: accepted {st['spec_accepted']:g} of "
                 f"{st['spec_proposed']:g} drafts ({rate:.4f}, want > "
                 f"{DRAFT_ACCEPT_MIN})")
        check_same_streams(cfg, eng.params, device, reqs, got, want,
                           f"{name} vs plain", eng.attn_lanes)
        say("times", f"generation {name}: proposed {st['spec_proposed']:g}, "
            f"accepted {st['spec_accepted']:g} ({rate:.4f}), draft faults "
            f"{st['draft_faults']:g}; {st['tokens'] / rec['wall']:.1f} "
            f"tokens/s in {rec['steps']} steps (step p50 "
            f"{rec['step_us']['p50'] / 1e3:.2f} ms) against the plain "
            f"engine's {prec['stats']['tokens'] / prec['wall']:.1f} in "
            f"{prec['steps']} (p50 {prec['step_us']['p50'] / 1e3:.2f} ms)"
            f"  [{card}]")
        recs[label] = rec
        del eng
        torch.cuda.empty_cache()
    return recs


def check_quant_logits(cfg, params_np, params, device):
    """(iv) forward_full with int8 and fp8 weights against fp32 on the same
    contexts (8 rows, lengths 40-320): max |diff|, MSE and greedy agreement
    of the last position's logits, printed beside the JAX package's budget
    for its small decoder (tests/test_quantized_serving.py)."""
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.generation import forward_full
    from paddle_tpu_torch.jit import load_reference_params
    rng = np.random.default_rng(GEN_SEED + 11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 320))
                            ).to(device)
    lens = torch.tensor(np.linspace(40, 320, 8).astype(np.int64),
                        device=device)
    lf = forward_full(cfg, params, toks, lens)[0]
    out = {}
    for mode in ("int8", "fp8"):
        qp = load_reference_params(
            cfg, quant.quantize_decoder_params(params_np, mode), device)
        lq = forward_full(cfg, qp, toks, lens)[0]
        d = (lq - lf).double()
        out[mode] = (float(d.abs().max()), float((d ** 2).mean()),
                     float((lq.argmax(-1) == lf.argmax(-1)).double().mean()))
        if not torch.isfinite(lq).all():
            fail(f"(iv) {mode} weights: non-finite logits")
        say("generate", f"(iv) {mode} weights vs fp32, forward_full over 8 "
            f"contexts of 40-320 tokens: logits max |diff| "
            f"{out[mode][0]:.4f}, MSE {out[mode][1]:.3e}, greedy agreement "
            f"{out[mode][2]:.4f} (the JAX package's budget for its 2-layer "
            f"decoder: {INT8_MAX_ABS}, {INT8_MSE:g})")
        del qp, lq
    return out


def count_int_mm(engine, reqs, warm=4, window=3):
    """``torch._int_mm`` calls a mixed step, from a profiler trace of
    ``window`` steady steps (requests straight into the engine). The engine
    is left mid-run."""
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        engine.submit(r)
    for _ in range(warm):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            engine.step()
        torch.cuda.synchronize()
    calls = sum(1 for e in prof.events() if e.name == "aten::_int_mm")
    return calls / window


def time_qmatmul(cfg, device, card, m=80):
    """One int8 ``qmatmul`` (activations quantized, ``torch._int_mm`` on the
    column-major int8 weight, the rescale) against the fp32 ``torch.matmul``
    at the decoder's shapes and the main path's 80 rows, device ms from a
    CUDA graph. Not a kernel of the port: a library call and torch ops."""
    from paddle_tpu_torch import quant
    g = torch.Generator().manual_seed(GEN_SEED + 12)
    total = [0.0, 0.0, 0.0]
    h = cfg.hidden
    # the decoder's matmuls: (K, N) of wqkv, wo, w1, w2 and the unembedding
    for k, n in ((h, 3 * h), (h, h), (h, 4 * h), (4 * h, h),
                 (h, cfg.vocab_size)):
        x = torch.randn(m, k, generator=g).to(device)
        w = torch.randn(k, n, generator=g)
        wq, sc = quant.quantize_array(w, 1, "int8")
        wq = wq.to(device).t().contiguous().t()
        sc = sc.to(device)
        wd = w.to(device)
        xq = torch.randint(-127, 128, (m, k), generator=g,
                           dtype=torch.int8).to(device)
        q_ms = device_ms([lambda: quant.qmatmul(x, wq, sc)])
        mm_ms = device_ms([lambda: torch._int_mm(xq, wq)])
        f_ms = device_ms([lambda: torch.matmul(x, wd)])
        for i, v in enumerate((q_ms, mm_ms, f_ms)):
            total[i] += v
        say("times", f"(iv) qmatmul [{m}, {k}] x [{k}, {n}]: {q_ms:.4f} ms "
            f"(torch._int_mm alone {mm_ms:.4f}), fp32 torch.matmul "
            f"{f_ms:.4f} ms  [{card}]")
        del x, w, wq, wd, xq
    say("times", f"(iv) a decoder layer's four matmuls and the unembedding at "
        f"{m} rows: qmatmul {total[0]:.4f} ms (torch._int_mm {total[1]:.4f})"
        f", fp32 {total[2]:.4f} ms  [{card}]")


def run_quant_weights(cfg, params_np, params, device, card, reqs,
                      fp32_streams):
    """(iv) int8 weights (KV auto -> int8) and fp8 weights on the main
    path's requests: logits against fp32, launches, the gauge, the
    ``torch._int_mm`` calls a step, one int8 mixed step against the CPU
    port, and qmatmul's time. Returns the records of the two runs."""
    from paddle_tpu_torch import monitor, quant
    from paddle_tpu_torch.generation import GenerationEngine
    check_quant_logits(cfg, params_np, params, device)
    recs = {}
    for mode in ("int8", "fp8"):
        eng = GenerationEngine(cfg, params_np, quant_mode=mode,
                               device=device, **GEN_GEO)
        saved = monitor.gauge_get("GAUGE_quant_weight_bytes_saved")
        want = quant.weight_bytes_saved(eng.params)
        if eng.kv_dtype != "int8" or saved != want or saved <= 0:
            fail(f"(iv) {mode} weights: KV {eng.kv_dtype}, "
                 f"GAUGE_quant_weight_bytes_saved {saved} against the "
                 f"checkpoint's {want}")
        eng.warmup()
        label = f"(iv) {mode} weights, KV auto -> int8"
        streams, rec = serve_generation(eng, reqs, label)
        check_gen_launches(rec, cfg, "int8", label)
        check_gen_outputs(streams, reqs, cfg, label)
        agree = np.mean([a == b for r in reqs for a, b in zip(
            streams[r.request_id], fp32_streams[r.request_id])
            if r.sampling.temperature <= 0])
        say("generate", f"{label}: GAUGE_quant_weight_bytes_saved {saved:g} "
            f"= weight_bytes_saved of the checkpoint; greedy token agreement "
            f"with fp32 weights and KV {agree:.4f} position by position")
        gen_times(rec, f"{mode} weights, int8 KV", card)
        if mode == "int8":
            per_step = count_int_mm(
                eng, gen_requests(cfg, 2 * GEN_GEO["decode_width"],
                                  seed=GEN_SEED + 1))
            if per_step != 4 * cfg.layers + 1:
                fail(f"{label}: {per_step} torch._int_mm calls a mixed "
                     f"step, want 4 x {cfg.layers} + 1")
            say("generate", f"{label}: {per_step:g} torch._int_mm calls a "
                f"mixed step (profiler) = 4 x {cfg.layers} layers + the "
                "unembedding")
        recs[f"{mode} weights"] = rec
        del eng
        torch.cuda.empty_cache()
    check_step_vs_cpu(cfg, params_np, device, kv="int8", weights="int8")
    time_qmatmul(cfg, device, card)
    return recs


def check_predictor_quant(device, card, bundle, p_fp32, feed):
    """(v) ``Config.enable_quant("int8")`` on the BERT-base encoder bundle:
    the scope holds int8 weights beside fp32 ``.quant_scale``, the output
    within the JAX package's budget against fp32 (max |diff| < 0.1, MSE <
    1e-3, tests/test_quantized_serving.py), and on a bucket ladder each
    replay bitwise equal to the eager run of its bucket."""
    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch.monitor import gauge_get, stat_get

    def predictor(buckets=None):
        cfg = TI.Config(bundle)
        cfg.enable_use_gpu(device_id=device.index or 0)
        cfg.enable_quant("int8")
        if buckets:
            cfg.switch_shape_bucketing(True, buckets=buckets)
        return TI.create_predictor(cfg)
    pq = predictor()
    ops = [op.type for op in pq.program.global_block.ops]
    n_deq = ops.count("fake_channel_wise_dequantize_max_abs")
    int8 = [n for b in pq.program.blocks for n, v in b.vars.items()
            if v.dtype == "int8"]
    for n in int8:
        w, sc = pq.scope.find_var(n), pq.scope.find_var(n + ".quant_scale")
        if w.dtype != torch.int8 or sc is None or sc.dtype != torch.float32 \
                or w.device != device or not bool((sc > 0).all()):
            fail(f"(v) enable_quant: {n} is {w.dtype}, its scale {sc}")
    if not int8 or n_deq != len(int8):
        fail(f"(v) enable_quant: {len(int8)} int8 weights, {n_deq} dequant "
             "ops")
    got = pq.run(feed)[0]
    want = p_fp32.run(feed)[0]
    d = (got - want).astype(np.float64)
    err, mse = float(np.abs(d).max()), float((d ** 2).mean())
    if not np.isfinite(got).all() or err >= 0.1 or mse >= 1e-3:
        fail(f"(v) enable_quant: max |diff| {err}, MSE {mse} against fp32 "
             "(budget 0.1, 1e-3)")
    pb = predictor(buckets="1,8")
    diffs = {}
    for b in (1, 8):
        f = [a[:b] for a in feed]
        cold = pb.run(f)[0]
        r0 = stat_get("STAT_predictor_graph_replay")
        rep = pb.run(f)[0]
        if stat_get("STAT_predictor_graph_replay") != r0 + 1:
            fail(f"(v) enable_quant bucket {b}: the run was not a replay")
        diffs[b] = float(np.abs(rep - cold).max())
        diffs[b] = max(diffs[b], float(np.abs(rep - pq.run(f)[0]).max()))
    if any(diffs.values()):
        fail(f"(v) enable_quant: replays differ from their eager runs "
             f"{diffs}")
    say("generate", f"(v) Predictor enable_quant('int8') on the BERT-base "
        f"bundle: {len(int8)} int8 weights with fp32 .quant_scale in the "
        f"scope, {n_deq} dequant ops, GAUGE_quant_weight_bytes_saved "
        f"{gauge_get('GAUGE_quant_weight_bytes_saved'):g}; "
        f"B={feed[0].shape[0]} against fp32: max |diff| {err:.4f} (budget 0.1), MSE {mse:.3e} "
        f"(budget 1e-3); each bucket's replay (captured with the dequant "
        "ops) against its eager run: " + ", ".join(
            f"b{b} {v:g}" for b, v in diffs.items()) + f"  [{card}]")
    del pq, pb


def run_generation(device, card, cfg_kw=GEN_CFG, n_requests=GEN_REQUESTS,
                   check_reqs=4):
    """Phase 8: the generation engine's main path at full width, its
    checks and its times, then the two-phase mode (i), speculative
    decoding with the ngram (ii) and model (iii) drafters, and int8 and
    fp8 weights (iv). Returns (paged parity errors, the records of every
    pool run by path, paged kernel times)."""
    from paddle_tpu_torch.generation import (DecoderConfig, GenerationEngine,
                                             init_params)
    from paddle_tpu_torch.jit import load_reference_params
    paged_err = check_paged(device)
    cfg = DecoderConfig(**cfg_kw)
    t0 = time.perf_counter()
    params_np = init_params(cfg, GEN_SEED)
    params = load_reference_params(cfg, params_np, device)
    n_params = sum(p.numel() for p in params.values())
    say("generate", f"decoder {cfg} ({n_params / 1e6:.1f} M parameters) "
        f"from init_params(seed {GEN_SEED}) via load_reference_params in "
        f"{time.perf_counter() - t0:.1f} s; engine {GEN_GEO}")
    reqs = gen_requests(cfg, n_requests)
    recs, streams = {}, {}
    for kv in ("fp32", "int8"):
        eng = GenerationEngine(cfg, params, kv_dtype=kv, device=device,
                               **GEN_GEO)
        eng.warmup()
        say("generate", f"{kv} engine: token budget {eng.token_budget}, "
            f"pool {eng.kv_pool_bytes() / 2 ** 30:.3f} GiB, "
            f"{eng.kv_capacity_seqs()} max-length sequences")
        label = f"main path, {kv} KV"
        streams[kv], recs[kv] = serve_generation(eng, reqs, label)
        check_gen_launches(recs[kv], cfg, kv, label)
        check_gen_outputs(streams[kv], reqs, cfg, label)
        if kv == "fp32" and (recs[kv]["stats"]["prefix_hits"] == 0 or
                             recs[kv]["stats"]["prefix_cow_copies"] == 0):
            fail(f"{label}: no prefix hit or copy-on-write")
        recs[kv]["profile"] = profile_generation(
            eng, gen_requests(cfg, 2 * GEN_GEO["decode_width"],
                              seed=GEN_SEED + 1), kv, card)
        del eng
        torch.cuda.empty_cache()
    # a rerun of the same requests from the same seeds
    eng = GenerationEngine(cfg, params, kv_dtype="fp32", device=device,
                           **GEN_GEO)
    again, _ = serve_generation(eng, reqs, "rerun, fp32 KV")
    if again != streams["fp32"]:
        bad = [i for i in again if again[i] != streams["fp32"][i]]
        fail(f"rerun: requests {bad} gave other token streams")
    say("generate", f"rerun: all {len(reqs)} token streams identical")
    del eng
    torch.cuda.empty_cache()
    agree = np.mean([a == b for r in reqs for a, b in zip(
        streams["fp32"][r.request_id], streams["int8"][r.request_id])
        if r.sampling.temperature <= 0])
    say("generate", f"int8 KV vs fp32 KV: greedy token agreement {agree:.4f}"
        " position by position")
    # correctness against full recompute and against the CPU port
    few = [r for r in gen_requests(cfg, 8, seed=GEN_SEED + 2, new_lo=24,
                                   new_hi=32, hi=320)][:check_reqs]
    for kv in ("fp32", "int8"):
        check_recompute(cfg, params, device, kv, few)
    for kv in ("fp32", "int8"):
        check_step_vs_cpu(cfg, params_np, device, kv)
    for kv in ("fp32", "int8"):
        gen_times(recs[kv], f"{kv} KV", card)
    # the rest of the engine: each path's pool run sets the counts to 0
    # just before and reads them just after
    t0 = time.perf_counter()
    recs["two-phase"] = run_two_phase(cfg, params, device, card, reqs,
                                      (streams["fp32"], recs["fp32"]), few)
    recs.update(run_spec(cfg, params, device, card))
    recs.update(run_quant_weights(cfg, params_np, params, device, card, reqs,
                                  streams["fp32"]))
    say("generate", f"two-phase, speculative decoding and quantized weights "
        f"in {time.perf_counter() - t0:.1f} s  [{card}]")
    del params
    torch.cuda.empty_cache()
    paged_times = time_paged(device, card)
    return paged_err, recs, paged_times


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 9: ResNet-50
# ---------------------------------------------------------------------------

CONV_NET_LR = 0.1


def build_conv_net(pt, c_in=3, hw=32, filters=16, classes=10):
    """The static conv net, built with package ``pt``'s layers (the port
    here; the tests also pass the JAX package): conv2d (3x3, no bias) ->
    batch_norm(act="relu") -> 2x2 max pool2d -> fc to ``classes`` ->
    softmax_with_cross_entropy -> mean; Momentum(CONV_NET_LR, 0.9).
    Returns (main, startup, loss)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data("img", [c_in, hw, hw])
        y = layers.data("label", [1], dtype="int64")
        h = layers.conv2d(x, filters, 3, padding=1, bias_attr=False)
        h = layers.pool2d(layers.batch_norm(h, act="relu"), 2, "max", 2)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(h, classes), y))
        pt.optimizer.Momentum(CONV_NET_LR, 0.9).minimize(
            loss, startup_program=startup, program=main)
    return main, startup, loss


def conv_net_feed(b, c_in=3, hw=32, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"img": rng.standard_normal((b, c_in, hw, hw)).astype(np.float32),
            "label": rng.integers(0, classes, (b, 1))}


RESNET_SEED = 5150
RESNET_HW = 224
RESNET_CLASSES = 1000
RESNET_PARITY_B = 4
RESNET_B = 256                       # bench.py:162's batch
RESNET_RERUN_B = 32
RESNET_LR, RESNET_MU = 0.1, 0.9
RESNET_WARMUP, RESNET_STEPS = 2, 10
RESNET_FLOPS_IMG = 3 * 2 * 4.09e9    # bench.py:158: 3 x 2 x 4.09 GMAC
RESNET_FALL = 0.9
# (i) resnet50 at B=4, 224 x 224 from one state, on the card and on the
# CPU port, in float64 and in fp32 (TF32 off). In float64 the two devices
# compute the same function (measured: every gradient within 1.3e-8 in
# norm, no ReLU input on the other side of 0): logits to 1e-9 of the
# largest, gradients, updates and running statistics to 1e-6, the loss
# (fp32 from the float64 logits) to 1e-6. In fp32 the eval logits to 1e-3
# of the largest, the loss to 1e-4, running statistics to 1e-4 (fp32 batch
# sums over 2e5-3e6 values a channel); but a ReLU input within fp32
# rounding of 0 takes the other side of the kink (measured: 111 of 38.4 M
# inputs on the card against the float64 run, 1,107 on the CPU, whose
# oneDNN convolutions round more), which moves every gradient below it:
# the card's fp32 gradients are 2.1% from its float64 ones in norm
# (median; 2.8% at worst), the CPU's 6.7% (8.7%). So gradients and
# updates are held in norm to 5e-2 of the card's float64 run and to
# 1.5e-1 of the CPU's fp32 run.
RESNET_TOL = dict(f64_logit=1e-9, f64=1e-6, logit=1e-3, loss_rtol=1e-4,
                  stat=(1e-4, 1e-4), grad_vs_f64=5e-2, grad_vs_cpu=1.5e-1)
# bf16 auto_cast top-1 against fp32 over B=256 random images of 1000
# random classes; the bf16 logits are ~1% off
RESNET_TOP1_MIN = 0.80
CONV_NET_B = 16
CONV_NET_TOL = dict(atol=1e-5, rtol=1e-4)


def resnet_state(model, seed):
    """Numpy weights and running statistics for every name of the model:
    conv weights N(0, sqrt(2 / fan_in)) (the model's own initializer),
    norm scales 1 + N(0, 0.1) and shifts N(0, 0.1), running means
    N(0, 0.1) and variances U(0.5, 1.5) (not 0 and 1), fc N(0, 0.01)."""
    from paddle_tpu_torch.jit import state_of
    rng = np.random.default_rng(seed)
    named = state_of(model)
    norms = {n[:-len("._mean")] for n in named if n.endswith("._mean")}
    state = {}
    for name, t in named.items():
        shape = tuple(t.shape)
        z = rng.standard_normal(shape, dtype=np.float32)
        prefix, _, leaf = name.rpartition(".")
        if prefix in norms and leaf == "_variance":
            state[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif prefix in norms:
            state[name] = 1.0 + 0.1 * z if leaf == "weight" else 0.1 * z
        elif len(shape) == 4:
            state[name] = z * np.float32(math.sqrt(2.0 / np.prod(shape[1:])))
        else:
            state[name] = 0.01 * z
    return state


def resnet_batch(b, device, seed=0):
    """bench.py's batch: images from np.random.RandomState(seed), then the
    labels."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (b, 1)).astype(np.int64)
    return ((torch.from_numpy(x).to(device),),
            (torch.from_numpy(y).to(device),))


def resnet_model(state, device):
    from paddle_tpu_torch.jit import load_reference_state
    from paddle_tpu_torch.models.resnet import resnet50
    model = resnet50(num_classes=RESNET_CLASSES, device=device)
    load_reference_state(model, state)
    return model


def resnet_step(model, amp_dtype=None):
    from paddle_tpu_torch import optimizer as T
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    opt = T.Momentum(RESNET_LR, RESNET_MU)
    step = TrainStep(model, lambda logits, label: F.cross_entropy(
        logits, label, reduction="mean"), opt, amp_dtype=amp_dtype)
    return step, opt


def norm_rel(got, want):
    """|got - want| / |want| in the 2-norm, in float64."""
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp_min(
        1e-30))


def resnet_parity_run(state, where, dtype):
    """resnet50 in ``dtype`` on ``where`` from ``state``: eval logits, then
    one TrainStep with Momentum(0.1, 0.9) on B=4; the loss, every gradient
    (the velocity after one step from 0), every parameter and running
    statistic after, and the sign of every ReLU input of the step's
    forward, all on the CPU."""
    from paddle_tpu_torch.nn.layers_lib import ReLU
    model = resnet_model(state, where).to(dtype)
    (x,), labels = resnet_batch(RESNET_PARITY_B, where, RESNET_SEED)
    inputs = (x.to(dtype),)
    model.eval()
    with torch.no_grad():
        logits = model(*inputs).double().cpu()
    signs = []
    hooks = [m.register_forward_hook(
        lambda m, args, out: signs.append((args[0] > 0).cpu()))
        for m in model.modules() if isinstance(m, ReLU)]
    step, opt = resnet_step(model)
    loss = float(step(inputs, labels))
    for h in hooks:
        h.remove()
    named = opt.named_parameters()
    return dict(logits=logits, loss=loss, signs=signs,
                grads={n: opt.accumulators(p)["velocity"].double().cpu()
                       for n, p in named.items()},
                params={n: p.detach().double().cpu()
                        for n, p in named.items()},
                stats={n: b.double().cpu() for n, b in
                       model.named_buffers()})


def parity_worst(a, b, before):
    """Worst norm-relative gaps of gradients and of updates (after - before),
    and the worst absolute gap of the running statistics."""
    grad = max(norm_rel(a["grads"][n], b["grads"][n]) for n in b["grads"])
    update = max(norm_rel(a["params"][n] - before[n],
                          b["params"][n] - before[n]) for n in b["params"])
    stat = max(float((a["stats"][n] - b["stats"][n]).abs().max())
               for n in b["stats"])
    return grad, update, stat


def check_resnet_vs_cpu(device, state):
    """(i) resnet50, B=4 at 224 x 224, on the card against the CPU port from
    one state, in float64 and in fp32 (RESNET_TOL): eval logits, one
    Momentum(0.1, 0.9) TrainStep's loss, every gradient, every running
    statistic (moved) and every parameter after."""
    cpu = torch.device("cpu")
    runs = {(tag, dt): resnet_parity_run(state, w, dt)
            for dt in (torch.float64, torch.float32)
            for tag, w in (("card", device), ("cpu", cpu))}
    before = {n: torch.from_numpy(state[n]).double() for n in
              runs[("cpu", torch.float64)]["params"]}
    g64, c64 = runs[("card", torch.float64)], runs[("cpu", torch.float64)]
    g32, c32 = runs[("card", torch.float32)], runs[("cpu", torch.float32)]
    for n in c64["stats"]:
        if torch.equal(c64["stats"][n], torch.from_numpy(state[n]).double()):
            fail(f"resnet step: running statistic {n} did not move")
    lines = []
    for label, a, b, logit_tol, loss_tol, grad_tol, stat_tol in (
            ("float64 card vs CPU", g64, c64, RESNET_TOL["f64_logit"],
             RESNET_TOL["f64"], RESNET_TOL["f64"], RESNET_TOL["f64"]),
            ("fp32 card vs CPU", g32, c32, RESNET_TOL["logit"],
             RESNET_TOL["loss_rtol"], RESNET_TOL["grad_vs_cpu"],
             sum(RESNET_TOL["stat"])),
            ("fp32 card vs float64 card", g32, g64, RESNET_TOL["logit"],
             RESNET_TOL["loss_rtol"], RESNET_TOL["grad_vs_f64"],
             sum(RESNET_TOL["stat"]))):
        scale = float(b["logits"].abs().max())
        logit = float((a["logits"] - b["logits"]).abs().max())
        loss = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        grad, update, stat = parity_worst(a, b, before)
        lines.append(f"{label}: logits {logit:.2e} (tol {logit_tol:g} x "
                     f"{scale:.1f}), loss {a['loss']:.9f} vs "
                     f"{b['loss']:.9f}, gradients {grad:.2e} and updates "
                     f"{update:.2e} in norm (tol {grad_tol:g}), statistics "
                     f"{stat:.2e} (tol {stat_tol:g})")
        if logit > logit_tol * scale or loss > loss_tol or \
                max(grad, update) > grad_tol or stat > stat_tol:
            fail(f"resnet parity, {lines[-1]}")
    flips = {k: sum(int((s != t).sum()) for s, t in
                    zip(runs[k]["signs"], g64["signs"]))
             for k in runs}
    n_relu = sum(t.numel() for t in g64["signs"])
    if flips[("cpu", torch.float64)]:
        fail(f"resnet parity: float64 ReLU inputs differ in sign between "
             f"the card and the CPU: {flips}")
    say("resnet", f"(i) resnet50 B={RESNET_PARITY_B} {RESNET_HW}x{RESNET_HW}"
        f", one Momentum({RESNET_LR}, {RESNET_MU}) step, "
        f"{len(c64['grads'])} gradients, {len(c64['stats'])} running "
        "statistics (moved), TF32 off; " + "; ".join(lines) + "; ReLU "
        f"inputs on the other side of 0 from the card's float64 run: card "
        f"fp32 {flips[('card', torch.float32)]}, CPU fp32 "
        f"{flips[('cpu', torch.float32)]}, CPU float64 "
        f"{flips[('cpu', torch.float64)]} of {n_relu}")


def check_conv_net_static(device):
    """(ii) the static conv -> batch_norm(relu) -> pool2d -> fc program:
    one Momentum step on the card against the CPU port from one startup
    state: the loss, every gradient, the moving statistics (moved, and
    alike), each op lowered once."""
    import collections
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.core.scope import Scope, load_reference_scope
    main, startup, loss = build_conv_net(tpt)
    startup.random_seed = RESNET_SEED
    cpu_scope = Scope()
    tpt.Executor("cpu").run(startup, scope=cpu_scope)
    names = [v.name for v in main.persistable_vars()
             if cpu_scope.has(v.name)]
    state = {n: cpu_scope.find_var(n).numpy().copy() for n in names}
    stats = [v.name for v in main.all_parameters() if not v.trainable]
    grads = [n for n in main.global_block.vars if n.endswith("@GRAD")]
    feed = conv_net_feed(CONV_NET_B, seed=RESNET_SEED)
    out = []
    for where in (device, "cpu"):
        scope = Scope()
        load_reference_scope(scope, state, where)
        exe = tpt.Executor(where)
        fetched = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                          scope=scope)
        out.append((fetched, {n: scope.find_var(n).cpu().numpy()
                              for n in names}, exe.lowered))
    (fg, sg, lowered), (fc, sc, _) = out
    want = collections.Counter(op.type for op in main.global_block.ops)
    if lowered != want:
        fail(f"static conv net: ops lowered {dict(lowered)}, program "
             f"{dict(want)}")
    for name, a, b in zip(["loss"] + grads, fg, fc):
        if not np.allclose(a, b, **CONV_NET_TOL):
            fail(f"static conv net: {name} card vs CPU off by "
                 f"{np.abs(a - b).max()}")
    for n in names:
        if not np.allclose(sg[n], sc[n], **CONV_NET_TOL):
            fail(f"static conv net: {n} after the step, card vs CPU off by "
                 f"{np.abs(sg[n] - sc[n]).max()}")
    moved = [n for n in stats if not np.array_equal(sg[n], state[n])]
    if len(moved) != 2 or set(stats) & set(grads):
        fail(f"static conv net: moving statistics {stats}, moved {moved}, "
             "or a gradient target")
    say("static", f"(ii) conv -> batch_norm(relu) -> pool2d -> fc program, "
        f"B={CONV_NET_B}: one Momentum step on the card vs the CPU port, "
        f"loss {float(fg[0]):.7f} vs {float(fc[0]):.7f}, {len(grads)} "
        f"gradients and {len(names)} persistables within "
        f"{CONV_NET_TOL['atol']:g} + {CONV_NET_TOL['rtol']:g}|ref|; moving "
        f"statistics {stats} moved by up to "
        f"{max(np.abs(sg[n] - state[n]).max() for n in stats):.4f}; ops "
        f"lowered once each: {dict(lowered)}")


RESNET_GROUPS = ("conv forward (cuDNN)", "conv data-gradient (cuDNN)",
                 "conv weight-gradient (cuDNN)", "conv layout conversions",
                 "batch-norm reductions",
                 "batch-norm affine and elementwise",
                 "ReLU and residual adds", "casts", "Momentum",
                 "other (pooling, fc, loss)")


def resnet_group(kernel, ranges):
    """The RESNET_GROUPS group of a kernel, from its name and the names of
    the ranges (torch ops and the phase's own annotations) that launched
    it."""
    low = kernel.lower()
    if "momentum" in ranges:
        return "Momentum"
    if "batch_norm.fwd" in ranges or "batch_norm.bwd" in ranges:
        return "batch-norm reductions" if "reduce" in low else \
            "batch-norm affine and elementwise"
    conv = [r for r in ranges if "convolution" in r]
    if conv:
        if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
            return "conv layout conversions"
        if any("backward" in r for r in conv):
            return "conv weight-gradient (cuDNN)" if "wgrad" in low else \
                "conv data-gradient (cuDNN)"
        return "conv forward (cuDNN)"
    if any(r in ranges for r in ("aten::relu", "aten::relu_",
                                 "aten::threshold_backward", "aten::add",
                                 "aten::add_", "aten::clamp_min")):
        return "ReLU and residual adds"
    if any(r in ranges for r in ("aten::_to_copy", "aten::copy_")):
        return "casts"
    return "other (pooling, fc, loss)"


class ResnetRanges:
    """Inside, batch norm's forward and backward (``_BatchNormTrain``) and
    the optimizer's update run under ``torch.profiler.record_function``
    ranges ("batch_norm.fwd", "batch_norm.bwd", "momentum"), so that the
    profiler can put their kernels in their groups; the functions are as
    they were on exit."""

    NAMES = ("batch_norm.fwd", "batch_norm.bwd", "momentum")

    def __init__(self, opt):
        self.opt = opt

    def __enter__(self):
        from torch.profiler import record_function
        from paddle_tpu_torch.nn import functional as F
        cls = F._BatchNormTrain
        self.saved = (cls, cls.forward, cls.backward)
        fwd, bwd = cls.forward, cls.backward

        def forward(ctx, *args):
            with record_function("batch_norm.fwd"):
                return fwd(ctx, *args)

        def backward(ctx, *grads):
            with record_function("batch_norm.bwd"):
                return bwd(ctx, *grads)
        cls.forward, cls.backward = staticmethod(forward), \
            staticmethod(backward)
        apply = self.opt._apply

        def momentum(step):
            with record_function("momentum"):
                return apply(step)
        self.opt._apply = momentum
        return self

    def __exit__(self, *exc):
        cls, fwd, bwd = self.saved
        cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)
        del self.opt._apply
        return False


def profile_resnet_step(fn, opt):
    """One call of ``fn`` under torch.profiler, with ResnetRanges: (device
    busy ms, kernels, ms by RESNET_GROUPS group, [ms, count] by kernel
    name). Each kernel is put in a group by the ranges that launched it;
    device time the profiler linked to no launching op is "unattributed".
    The ranges also appear on the device's timeline; they are left out."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with ResnetRanges(opt), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in events):
            break
    else:
        fail("three profiler traces of a resnet step held no device event")
    busy, n_kernels, by_name = 0.0, 0, {}
    for e in events:
        # the ranges' own spans on the device's timeline are not kernels
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.name in ResnetRanges.NAMES:
            continue
        n_kernels += 1
        t = e.time_range.elapsed_us() / 1e3
        busy += t
        ms_n = by_name.setdefault(e.name[:90], [0.0, 0])
        ms_n[0] += t
        ms_n[1] += 1
    groups = {g: 0.0 for g in RESNET_GROUPS}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        ranges, up = set(), e
        while up is not None:
            ranges.add(up.name)
            up = up.cpu_parent
        for k in e.kernels:
            groups[resnet_group(k.name, ranges)] += k.duration / 1e3
    groups["unattributed"] = max(0.0, busy - sum(groups.values()))
    return busy, n_kernels, groups, by_name


def bn_input_elements(model, b):
    """Elements a pass over every batch-norm input holds at batch ``b``,
    from the shapes of one forward of one image."""
    from paddle_tpu_torch.nn.layers_lib import BatchNorm2D
    sizes = []
    hooks = [m.register_forward_hook(
        lambda m, args, out: sizes.append(args[0].numel()))
        for m in model.modules() if isinstance(m, BatchNorm2D)]
    try:
        model.eval()
        with torch.no_grad():
            model(resnet_batch(1, next(model.parameters()).device)[0][0])
    finally:
        for h in hooks:
            h.remove()
    return sum(sizes) * b


def time_steps(step, batch, n):
    times, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return times, losses


def resnet_main_path(device, state, card):
    """(iii) the main path, bench.py's cell: resnet50, B=256 (halved while
    it does not fit), 224 x 224, 1000 classes, bf16 TrainStep with
    Momentum(0.1, 0.9) on one batch from np.random.RandomState(0); 2
    warm-up steps, then 10 timed, the kernels' counts set to 0 just before
    and read just after. Returns (batch, counts, step, model, opt)."""
    b = RESNET_B
    while True:
        try:
            model = resnet_model(state, device)
            step, opt = resnet_step(model, "bfloat16")
            batch = resnet_batch(b, device)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            warm = [float(step(*batch)) for _ in range(RESNET_WARMUP)]
            times, losses = time_steps(step, batch, RESNET_STEPS)
            counts = read_counts()
            break
        except torch.cuda.OutOfMemoryError:
            if b <= 32:
                raise
            say("resnet", f"B={b} does not fit on the card: halved to "
                f"{b // 2}")
            model = step = opt = batch = None
            gc.collect()
            torch.cuda.empty_cache()
            b //= 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = warm + losses
    # at lr 0.1 without warmup on one repeated batch the loss falls by a
    # fifth in 4-11 steps and then jumps (7.04 -> 5.55 -> 9.18 at step 12
    # on an H100), alike with cuDNN's batch norm in place of the port's and
    # in fp32: falling means a step a tenth below the first
    if not all(math.isfinite(v) for v in losses) or \
            not min(losses[1:]) < RESNET_FALL * losses[0]:
        fail(f"resnet main path: losses not finite or not falling: {losses}")
    if any(counts.values()):
        fail(f"resnet main path launched a kernel of another path: {counts}")
    ms = 1e3 * float(np.median(times))
    flops = RESNET_FLOPS_IMG * b
    mfu = flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    say("resnet", f"(iii) main path: resnet50 B={b} {RESNET_HW}x{RESNET_HW} "
        f"bf16 TrainStep Momentum({RESNET_LR}, {RESNET_MU}), "
        f"torch.backends.cudnn.deterministic = "
        f"{torch.backends.cudnn.deterministic}, benchmark = "
        f"{torch.backends.cudnn.benchmark}; losses " +
        " ".join(f"{v:.5f}" for v in losses) + f"; the seven kernels' "
        f"launches {sum(counts.values())} (no kernel on this path: "
        f"convolution is cuDNN's, batch norm and pooling torch ops)")
    busy, n_kernels, groups, by_name = profile_resnet_step(
        lambda: step(*batch), opt)
    idle = max(0.0, 1.0 - busy / ms)
    say("times", f"resnet50 train step B={b} bf16: eager {ms:.2f} ms median "
        f"of {RESNET_STEPS}, {b / ms * 1e3:.1f} images/s, MFU {mfu:.4f} "
        f"({flops / 1e12:.3f} TFLOP a step at 989 TFLOP/s); device busy "
        f"{busy:.2f} ms in {n_kernels} kernels, idle share {idle:.3f}; peak "
        f"memory {peak:.2f} GiB  [{card}]")
    bn_elems = bn_input_elements(model, b)
    # forward reads x and writes y; backward reads x and dy, writes dx
    bn_bound, _ = bound_ms(5 * bn_elems * 2, 0.0, torch.bfloat16)
    bn_ms = groups["batch-norm reductions"] + \
        groups["batch-norm affine and elementwise"]
    say("profile", "resnet50 step device time: " + ", ".join(
        f"{g} {t:.2f} ms ({t / busy:.1%})" for g, t in groups.items()) +
        f"  [{card}]")
    say("profile", f"resnet50 batch norm: {bn_ms:.2f} ms a step over "
        f"{bn_elems / 1e9:.3f} G input elements ({bn_elems * 2 / 1e9:.2f} GB "
        f"a pass in bf16, {bn_elems / b / 1e6:.2f} M an image); bytes bound "
        f"{bn_bound:.2f} ms (x, y, dy, dx once each at 3.35 TB/s)  [{card}]")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    say("profile", "resnet50 step top kernels: " + "; ".join(
        f"{name} {t:.2f} ms x{n}" for name, (t, n) in top) + f"  [{card}]")
    return batch, counts, step, model, opt, ms


def check_resnet_rerun(device, state):
    """Two bf16 steps at B=32 from the same state, twice, under
    torch.backends.cudnn.deterministic = True: the losses, running
    statistics and parameters equal bit for bit."""
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            model = resnet_model(state, device)
            step, _ = resnet_step(model, "bfloat16")
            batch = resnet_batch(RESNET_RERUN_B, device, 1)
            losses = [float(step(*batch)) for _ in range(2)]
            runs.append((losses, {n: t.detach().clone() for n, t in
                                  model.state_dict().items()}))
            del model, step
    finally:
        torch.backends.cudnn.deterministic = saved
    (l1, s1), (l2, s2) = runs
    diff = [n for n in s1 if not torch.equal(s1[n], s2[n])]
    if l1 != l2 or diff:
        fail(f"resnet rerun: losses {l1} vs {l2}, {len(diff)} tensors "
             f"differ: {diff[:4]}")
    say("resnet", f"rerun: two bf16 steps at B={RESNET_RERUN_B} from one "
        "state, twice, under torch.backends.cudnn.deterministic = True: "
        f"losses {l1} both times, {len(s1)} parameters and running "
        "statistics equal bit for bit")


def resnet_serving(model, card):
    """(iv) eval forward at the main path's batch under bf16 auto_cast:
    eager ms (median of 20), images/s, device ms from a CUDA-graph replay;
    bf16 top-1 against fp32."""
    from paddle_tpu_torch import amp
    x = resnet_batch(RESNET_B, next(model.parameters()).device)[0][0]
    model.eval()

    def forward(bf16):
        with torch.no_grad(), amp.auto_cast(enable=bf16):
            return model(x)
    top32 = forward(False).argmax(-1)
    top16 = forward(True).argmax(-1)
    agree = float((top32 == top16).float().mean())
    if agree < RESNET_TOP1_MIN:
        fail(f"resnet eval: bf16 top-1 agrees with fp32 at {agree}")
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times))
    dev = device_ms([lambda: forward(True)], reps=3)
    say("times", f"(iv) resnet50 eval forward B={RESNET_B} bf16 auto_cast: "
        f"{ms:.2f} ms median of 20, {RESNET_B / ms * 1e3:.1f} images/s; "
        f"device {dev:.2f} ms from a CUDA graph "
        f"({RESNET_B / dev * 1e3:.1f} images/s), idle share "
        f"{max(0.0, 1.0 - dev / ms):.3f}; bf16 top-1 agrees with fp32 at "
        f"{agree:.4f} (min {RESNET_TOP1_MIN})  [{card}]")


def time_bn_yardstick(device, card, shape=(256, 256, 56, 56)):
    """(v) one stage-1 batch norm, training, forward and backward, bf16 x:
    the port's batch norm against torch.nn.functional.batch_norm (cuDNN's,
    timed here only), beside the bytes bound."""
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device=device).manual_seed(RESNET_SEED)
    c = shape[1]
    x = torch.randn(shape, device=device, generator=gen,
                    dtype=torch.bfloat16).requires_grad_()
    dy = torch.randn(shape, device=device, generator=gen,
                     dtype=torch.bfloat16)
    w = torch.ones(c, device=device, requires_grad=True)
    bias = torch.zeros(c, device=device, requires_grad=True)
    mean = torch.zeros(c, device=device)
    var = torch.ones(c, device=device)

    def port():
        y = F.batch_norm_op(x, w, bias, mean, var)[0]
        torch.autograd.grad(y, (x, w, bias), dy)

    def cudnn():
        y = torch.nn.functional.batch_norm(x, mean.clone(), var.clone(), w,
                                           bias, training=True)
        torch.autograd.grad(y, (x, w, bias), dy)
    port_ms = profiled_ms(port)
    lib_ms = profiled_ms(cudnn)
    bound, _ = bound_ms(5 * x.numel() * 2, 0.0, torch.bfloat16)
    say("times", f"(v) batch norm {list(shape)} bf16, training forward + "
        f"backward: the port {port_ms:.3f} ms, "
        f"torch.nn.functional.batch_norm (cuDNN) {lib_ms:.3f} ms, bytes "
        f"bound {bound:.3f} ms  [{card}]")
    return port_ms, lib_ms, bound


def time_channels_last(device, state, card, b):
    """(v) the main path's step with the model and input in
    torch.channels_last (logical shapes NCHW): eager ms, median of 10."""
    model = resnet_model(state, device).to(memory_format=torch.channels_last)
    step, _ = resnet_step(model, "bfloat16")
    (x,), labels = resnet_batch(b, device)
    batch = ((x.contiguous(memory_format=torch.channels_last),), labels)
    time_steps(step, batch, RESNET_WARMUP)
    times, losses = time_steps(step, batch, RESNET_STEPS)
    if not all(math.isfinite(v) for v in losses):
        fail(f"resnet channels_last: losses not finite: {losses}")
    ms = 1e3 * float(np.median(times))
    say("times", f"(v) resnet50 train step B={b} bf16 in channels_last: "
        f"{ms:.2f} ms median of {RESNET_STEPS}, {b / ms * 1e3:.1f} "
        f"images/s  [{card}]")
    return ms


def run_resnet(device, card):
    """Phase 9: ResNet-50 on the card."""
    t0 = time.perf_counter()
    from paddle_tpu_torch.models.resnet import resnet50
    state = resnet_state(resnet50(num_classes=RESNET_CLASSES,
                                  device="cpu"), RESNET_SEED)
    check_resnet_vs_cpu(device, state)
    check_conv_net_static(device)
    torch.cuda.empty_cache()
    batch, counts, step, model, opt, ms = resnet_main_path(device, state,
                                                           card)
    b = batch[0][0].shape[0]
    resnet_serving(model, card)
    del batch, step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    check_resnet_rerun(device, state)
    time_bn_yardstick(device, card)
    cl_ms = time_channels_last(device, state, card, b)
    say("times", f"(v) resnet50 step NCHW {ms:.2f} ms vs channels_last "
        f"{cl_ms:.2f} ms at B={b}  [{card}]")
    torch.cuda.empty_cache()
    say("resnet", f"phase done in {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 10: Paddle Inference (io, Predictor, shape buckets, PredictorPool)
# ---------------------------------------------------------------------------

# BertConfig()'s widths (Paddle 1.8's static BERT, bert.py BertModel)
INFER_CFG = dict(layers_n=12, H=768, heads=12, FF=3072, vocab=30522,
                 max_pos=512, types=2, S=128)
INFER_SEED = 777
INFER_FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")


def build_bert_encoder(pt, layers_n=12, H=768, heads=12, FF=3072,
                       vocab=30522, max_pos=512, types=2, S=128,
                       dropout=0.1):
    """BERT's encoder as Paddle 1.8's static BertModel builds it, with
    package ``pt``'s layers (the port here; the tests also pass the JAX
    package): three lookup_table embeddings of [B, S, 1] int64 ids summed,
    layer_norm(begin_norm_axis=2) and upscale_in_train dropout; the
    [B, 1, 1, S] input_mask made the additive key bias by scale(10000,
    bias -1, before the scale); then post-LN layers of
    multi_head_attention, dropout, residual and layer_norm, fc(gelu) to FF
    and fc back to H, dropout, residual and layer_norm, with the reshapes
    of tools/check_backward_replay.py:89-121. Returns (main, startup,
    the [B, S, H] sequence output)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = [layers.data(n, [S, 1], dtype="int64")
               for n in INFER_FEEDS[:3]]
        mask = layers.data("input_mask", [1, 1, S])
        emb = None
        for x, rows, name in zip(ids, (vocab, max_pos, types),
                                 ("word_embedding", "pos_embedding",
                                  "sent_embedding")):
            e = layers.embedding(x, size=[rows, H],
                                 param_attr=pt.ParamAttr(name=name))
            emb = e if emb is None else layers.elementwise_add(emb, e)
        h = layers.dropout(
            layers.layer_norm(emb, begin_norm_axis=2), dropout,
            dropout_implementation="upscale_in_train")
        bias = layers.scale(mask, scale=10000.0, bias=-1.0,
                            bias_after_scale=False)
        for _ in range(layers_n):
            a = layers.dropout(
                layers.multi_head_attention(h, heads, attn_mask=bias),
                dropout, dropout_implementation="upscale_in_train")
            h = layers.reshape(layers.layer_norm(
                layers.elementwise_add(a, h), begin_norm_axis=2), [-1, S, H])
            f = layers.fc(layers.reshape(
                layers.fc(h, FF, act="gelu", num_flatten_dims=2),
                [-1, S, FF]), H, num_flatten_dims=2)
            f = layers.dropout(f, dropout,
                               dropout_implementation="upscale_in_train")
            h = layers.reshape(layers.layer_norm(
                layers.elementwise_add(f, h), begin_norm_axis=2), [-1, S, H])
    return main, startup, h


def bert_encoder_state(main, seed=INFER_SEED):
    """Numpy values of every parameter of the program: N(0, 0.02) like
    BERT's initializer_range, layer-norm scales 1 + N(0, 0.1) and shifts
    N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    state = {}
    for v in main.all_parameters():
        z = rng.standard_normal(tuple(v.shape), dtype=np.float32)
        if v.name.startswith("layer_norm."):
            state[v.name] = (1.0 if ".w_" in v.name else 0.0) + 0.1 * z
        else:
            state[v.name] = 0.02 * z
    return state


def bert_encoder_feed(b, cfg=INFER_CFG, seed=INFER_SEED + 1, lo=None):
    """Feeds of ``b`` rows: random ids, positions 0..S-1, sentence 0 then
    1, and a mask of row lengths drawn from ``lo``..S (all S when lo is
    None)."""
    rng = np.random.default_rng(seed)
    s = cfg["S"]
    src = rng.integers(0, cfg["vocab"], (b, s, 1))
    pos = np.broadcast_to(np.arange(s)[None, :, None], (b, s, 1)).copy()
    sent = (np.arange(s)[None, :, None] >= s // 2).repeat(b, 0)
    lens = np.full(b, s) if lo is None else rng.integers(lo, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    return [src.astype(np.int64), pos.astype(np.int64),
            sent.astype(np.int64), mask[:, None, None, :]]


# the phase's request shapes: (iii) requests against their exact-shape
# eager runs, (vi) the timed batches
INFER_LADDER = "pow2:32"
INFER_REQUEST_ROWS = (3, 8, 17)
INFER_TIME_B = (1, 8, 32)
INFER_CPU_B = 2
# (iv) bf16 against fp32 in relative norm: 12 layers of bf16 activations
INFER_BF16_REL = 2e-2
# (v) the pool: client threads x requests of 1-8 rows, lengths 16-128
POOL_THREADS, POOL_PER_THREAD = 4, 32
POOL_ROWS, POOL_MIN_LEN = (1, 8), 16


def infer_counts():
    """(flash forward, layer-norm forward) launches and the two path
    logs."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    attn, ln = static_paths()
    return FA.launches, LN.launches, attn, ln


def reset_infer_counts():
    reset_counts()
    reset_static_logs()


def bucket_graph(pred, b):
    """The captured graph of a predictor's bucket of ``b`` rows."""
    for sig, entry in pred._graphs.items():
        if dict((n, shape) for n, shape, _ in sig)["src_ids"][0] == b:
            return entry
    fail(f"[inference] no graph captured for bucket {b}")


def graph_device_ms(entry, reps=10):
    """Device time of one replay of a captured bucket, CUDA events around
    ``reps`` replays."""
    entry.graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        entry.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_replay(fn, lead=64):
    """One call of ``fn`` under torch.profiler, after ``lead`` spin
    kernels (~4 ms) in the same trace: after the earlier phases' traces a
    session loses its first activity records (2 memcpys after the ResNet
    phase, a layer norm of the replay after all of them), and the spins
    take that loss. Returns (device events after the last spin, their busy ms,
    [ms, count] by name)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(100000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spins = [e.time_range.start for e in dev if "spin_kernel" in e.name]
    if not spins:
        fail("[inference] a profiler trace held none of its lead kernels")
    after = [e for e in dev if e.time_range.start > max(spins)]
    by_name = {}
    for e in after:
        ms_n = by_name.setdefault(e.name[:90], [0.0, 0])
        ms_n[0] += e.time_range.elapsed_us() / 1e3
        ms_n[1] += 1
    return len(after), sum(v[0] for v in by_name.values()), by_name


def host_ms(fn, reps=5):
    """Median host ms of ``fn`` (each call ends in a copy to the host)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def rel_norm(got, want):
    return float(np.linalg.norm((got - want).ravel()) /
                 max(np.linalg.norm(want.ravel()), 1e-30))


def check_warmup(report, what):
    """Fail on a bucket that ``warmup_buckets`` reports as failed (the
    program cache's ladder reports an error instead of raising it)."""
    bad = {b: r["error"] for b, r in report.items() if "error" in r}
    if bad:
        fail(f"[inference] {what}: warmup failed at buckets {bad}")
    return report


def check_close(what, got, want, tol=CPU_TOL):
    err = float(np.abs(got - want).max())
    if not np.all(np.abs(got - want) <= tol["atol"] + tol["rtol"] *
                  np.abs(want)):
        fail(f"[inference] {what}: max error {err} (tol {tol['atol']:g} + "
             f"{tol['rtol']:g}|ref|)")
    return err


def pool_requests(seed=INFER_SEED + 2):
    rng = np.random.default_rng(seed)
    return [bert_encoder_feed(int(rng.integers(POOL_ROWS[0],
                                               POOL_ROWS[1] + 1)),
                              seed=seed * 1000 + i, lo=POOL_MIN_LEN)
            for i in range(POOL_THREADS * POOL_PER_THREAD)]


def drive_pool(pool, reqs):
    """Every request through ``pool`` from POOL_THREADS client threads:
    (answers, latencies in ms, wall s)."""
    import threading
    outs, lat = [None] * len(reqs), [0.0] * len(reqs)
    errors = []

    def client(t):
        try:
            for i in range(t, len(reqs), POOL_THREADS):
                t0 = time.perf_counter()
                outs[i] = pool.run(reqs[i], timeout=300)[0]
                lat[i] = 1e3 * (time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(POOL_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return outs, lat, wall


def time_infer_kernels(device, card):
    """The two kernels at this path's calls, B=8 S=128: the layer-norm
    forward over [1024, 768] (fp32, and bf16 with bf16 scale and shift)
    and the flash forward on the packed projection's q, k, v views
    [8,12,128,64] with the [8,1,1,128] key bias, fp32 and bf16; kernel,
    bound, plain version and library call."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    b, s, h, d = 8, INFER_CFG["S"], INFER_CFG["heads"], 64
    hid = h * d
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        per = b * s * hid * (4 if dtype == torch.float32 else 2)

        def ln_make(i):
            x, g, bt = ln_inputs(b * s, hid, dtype, device, 700 + i)
            return x, g.to(dtype), bt.to(dtype)
        sets = copies(ln_make, per)
        ms = device_ms([lambda x=x: LN.layer_norm_fwd(*x) for x in sets])
        plain_ms = device_ms([lambda x=x: LN.layer_norm_reference(*x)
                              for x in sets])
        lib_ms = device_ms([lambda x=x: torch.nn.functional.layer_norm(
            x[0], (hid,), x[1], x[2], 1e-5) for x in sets])
        bms, by = bound_ms(*ln_work(sets[0][0], sets[0][1]), dtype)
        rec[("ln", dtype)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bms, bound_by=by)
        say("times", f"[inference] layer_norm fwd [{b * s}x{hid}] "
            f"{str(dtype)[6:]}: kernel {ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), plain {plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} ms"
            f"  [{card}]")

        def fa_make(i):
            g = torch.Generator().manual_seed(800 + i)
            qkv = torch.randn(b, s, 3, h, d, generator=g).to(dtype).to(device)
            bias = padding_bias(b, s, device, 900 + i, lo=POOL_MIN_LEN)
            return (qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2),
                    qkv[:, :, 2].transpose(1, 2), bias)
        sets = copies(fa_make, 3 * per)
        ms = device_ms([lambda x=x: FA.flash_attention_fwd(*x) for x in sets])
        plain_ms = device_ms([lambda x=x: FA.attention_reference(*x)
                              for x in sets])
        lib_ms = device_ms([lambda x=x: torch.nn.functional
                            .scaled_dot_product_attention(
                                x[0], x[1], x[2], attn_mask=x[3] > -1.0,
                                scale=1.0 / math.sqrt(d)) for x in sets])
        bms, by = bound_ms(*attn_work(sets[0][0], sets[0][1], sets[0][3],
                                      False), dtype)
        rec[("flash", dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bms,
                                     bound_by=by)
        say("times", f"[inference] flash fwd {str(dtype)[6:]} "
            f"[{b},{h},{s},{d}] packed views, bias [B,1,1,S]: kernel "
            f"{ms:.4f} ms, bound {bms:.4f} ms ({by}), plain {plain_ms:.4f} "
            f"ms, SDPA {lib_ms:.4f} ms  [{card}]")
        del sets
    return rec


def run_inference(device, card, bundle):
    """Phase 10: the BERT-base encoder bundle (saved into the directory
    ``bundle``, which phase 10b serves again) through io, Predictor, shape
    buckets as CUDA graphs and PredictorPool. Returns the main path's
    launches, (flash forward, layer-norm forward): the pool's warmup
    (each bucket's cold eager run and capture) and its traffic, counts set
    to 0 just before and read just after."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch import serving as TS
    from paddle_tpu_torch.core.scope import load_reference_scope
    from paddle_tpu_torch.monitor import reset_all, stat_get, timer_get
    t_phase = time.perf_counter()
    n_layers = INFER_CFG["layers_n"]
    n_ln = 2 * n_layers + 1
    torch.cuda.reset_peak_memory_stats()
    main_prog, _, out = build_bert_encoder(pt, **INFER_CFG)
    state = bert_encoder_state(main_prog)
    scope = pt.Scope()
    load_reference_scope(scope, state, "cpu")
    t0 = time.perf_counter()
    pt.save_inference_model(bundle, list(INFER_FEEDS), [out],
                            pt.Executor("cpu"), main_program=main_prog,
                            scope=scope)
    del scope, state
    say("inference", f"BERT-base encoder {INFER_CFG} built with the port's "
        f"layers ({len(main_prog.global_block.ops)} ops), weights from numpy "
        f"seed {INFER_SEED}, saved by io.save_inference_model in "
        f"{time.perf_counter() - t0:.1f} s")

    def predictor(ir=True, bf16=False, buckets=None, cpu=False):
        cfg = TI.Config(bundle)
        if cpu:
            cfg.disable_gpu()
        else:
            cfg.enable_use_gpu(device_id=device.index or 0)
        cfg.switch_ir_optim(ir)
        if bf16:
            cfg.enable_bf16()
        if buckets:
            cfg.switch_shape_bucketing(True, buckets=buckets)
        return TI.create_predictor(cfg)

    # (i) fp32 with the pipeline on: the card against the CPU port; off
    # against on, on the card
    p_on, p_off, p_cpu = predictor(), predictor(ir=False), \
        predictor(cpu=True)
    ops = [op.type for op in p_on.program.global_block.ops]
    if ops.count("multihead_matmul") != n_layers or \
            ops.count("fused_embedding_eltwise_layernorm") != 1 or \
            "dropout" in ops or "lookup_table" in ops:
        fail(f"[inference] the pass pipeline left {sorted(set(ops))}")
    feed2 = bert_encoder_feed(INFER_CPU_B, lo=POOL_MIN_LEN)
    got = p_on.run(feed2)[0]
    want = p_cpu.run(feed2)[0]
    if got.shape != (INFER_CPU_B, INFER_CFG["S"], INFER_CFG["H"]) or \
            not np.isfinite(got).all():
        fail(f"[inference] output {got.shape}, finite {np.isfinite(got).all()}")
    e_cpu = check_close("fp32 card vs CPU port", got, want)
    e_off = check_close("fp32 ir_optim off vs on, card",
                        p_off.run(feed2)[0], got)
    del p_cpu
    say("inference", f"(i) fp32 B={INFER_CPU_B}: card vs CPU port max error "
        f"{e_cpu:.3e}, ir_optim off vs on {e_off:.3e} (tol CPU_TOL); "
        f"max |out| {float(np.abs(want).max()):.3f}; {len(ops)} ops after the "
        f"passes ({len(p_off.program.global_block.ops)} without)")

    # (ii) launches in one eager forward
    feed8 = bert_encoder_feed(8, lo=POOL_MIN_LEN)
    # phase 8's (v): weight-only int8 on this bundle
    check_predictor_quant(device, card, bundle, p_on, feed8)
    for name, pred, flash in (("on", p_on, n_layers), ("off", p_off, 0)):
        reset_infer_counts()
        pred.run(feed8)
        torch.cuda.synchronize()
        fa, ln, attn, lnp = infer_counts()
        if (fa, ln) != (flash, n_ln) or attn != ["flash"] * flash or \
                lnp != ["kernel"] * n_ln:
            fail(f"[inference] ir_optim {name}: launches flash {fa}, layer "
                 f"norm {ln}, paths {sorted(set(attn))} x {len(attn)}, "
                 f"{sorted(set(lnp))} x {len(lnp)}; expected {flash} and "
                 f"{n_ln}")
        say("inference", f"(ii) one eager forward B=8, ir_optim {name}: flash "
            f"{fa}, layer norm {ln} launches; path logs {len(attn)} x "
            f"'flash', {len(lnp)} x 'kernel'")

    # (v) the main path: PredictorPool over a bucketed Config, warmed up
    # (every bucket captured, largest first), then the clients' traffic;
    # counts set to 0 just before and read just after
    reqs = pool_requests()
    ladder = TI.parse_bucket_ladder(INFER_LADDER)
    reset_all()
    reset_infer_counts()
    cfg = TI.Config(bundle)
    cfg.enable_use_gpu(device_id=device.index or 0)
    cfg.switch_shape_bucketing(True, buckets=INFER_LADDER)
    pool = TS.serve(cfg, max_batch=max(ladder), batch_timeout_ms=2.0)
    t0 = time.perf_counter()
    report = check_warmup(pool.warmup([f[:1] for f in reqs[0]]), "the pool")
    t_warm = time.perf_counter() - t0
    outs, lat, wall = drive_pool(pool, reqs)
    torch.cuda.synchronize()
    fa, ln, attn, lnp = infer_counts()
    main_counts = (fa, ln)
    captures = stat_get("STAT_predictor_graph_capture")
    replays = stat_get("STAT_predictor_graph_replay")
    batches = stat_get("STAT_serving_batches")
    want_fa, want_ln = 2 * len(ladder) * n_layers, 2 * len(ladder) * n_ln
    if (fa, ln) != (want_fa, want_ln) or captures != len(ladder) or \
            replays != batches or set(attn) != {"flash"} or \
            set(lnp) != {"kernel"} or stat_get("STAT_predictor_bucket_cold"):
        fail(f"[inference] pool: launches {fa}/{ln} (expected {want_fa}/"
             f"{want_ln}: each bucket's cold run and capture), captures "
             f"{captures}, replays {replays} for {batches} batches")
    p_b = pool.predictor
    errs = [check_close(f"pool request {i}", o, p_on.run(r)[0])
            for i, (o, r) in enumerate(zip(outs, reqs))]
    rows = sum(r[0].shape[0] for r in reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("inference", f"(v) main path: PredictorPool ({INFER_LADDER}, "
        f"max_batch {max(ladder)}) warmup captured {int(captures)} graphs "
        "largest first in " + ", ".join(
            f"b{k} {v['seconds']:.2f}" for k, v in report.items()) +
        f" s ({t_warm:.1f} s); {POOL_THREADS} threads x {POOL_PER_THREAD} "
        f"requests ({rows} rows) in {int(batches)} batches, "
        f"{int(replays)} graph replays; launches flash {fa}, layer norm {ln} "
        f"(the warmup's cold runs and captures: replays launch from the "
        f"graph); every answer against the request alone, max error "
        f"{max(errs):.3e}; peak memory {peak:.2f} GiB")

    # (iii) the ladder: requests against their exact-shape eager runs,
    # each bucket's replay against its eager run, one replay profiled
    worst = []
    for b in INFER_REQUEST_ROWS:
        f = bert_encoder_feed(b, seed=INFER_SEED + 10 + b, lo=POOL_MIN_LEN)
        worst.append(check_close(f"{b} rows bucketed vs exact",
                                 p_b.run(f)[0], p_on.run(f)[0]))
    diffs = {}
    for b in ladder:
        f = bert_encoder_feed(b, seed=INFER_SEED + 50 + b, lo=POOL_MIN_LEN)
        r0 = stat_get("STAT_predictor_graph_replay")
        got = p_b.run(f)[0]
        if stat_get("STAT_predictor_graph_replay") != r0 + 1:
            fail(f"[inference] bucket {b}: the run was not a replay")
        diffs[b] = float(np.abs(got - p_on.run(f)[0]).max())
    if any(diffs.values()):
        fail(f"[inference] replays differ from their eager buckets: {diffs}")
    reset_infer_counts()
    n_k, busy, by_name = profile_replay(lambda: p_b.run(feed8))
    fa, ln, _, _ = infer_counts()
    k_fa = sum(c for n, (_, c) in by_name.items() if "flash_fwd" in n)
    k_ln = sum(c for n, (_, c) in by_name.items() if "layer_norm_fwd" in n)
    if (k_fa, k_ln) != (n_layers, n_ln) or (fa, ln) != (0, 0):
        fail(f"[inference] one replay's trace: {k_fa} flash and {k_ln} "
             f"layer-norm forward kernels (expected {n_layers}, {n_ln}); "
             f"Python counts {fa}/{ln}")
    say("inference", f"(iii) {INFER_LADDER} at S={INFER_CFG['S']}: requests "
        f"of {INFER_REQUEST_ROWS} rows vs their exact-shape eager runs max "
        f"error {max(worst):.3e}; each replay vs the eager run of its bucket "
        f"max difference " + ", ".join(f"b{b} {d:g}" for b, d in
                                      diffs.items()) +
        f"; one B=8 replay's profile: {n_k} kernels, {k_fa} flash forward, "
        f"{k_ln} layer-norm forward, device busy {busy:.3f} ms")

    # (iv) bf16 against fp32 on the bf16 instances; without the pipeline
    # the bf16 scores meet the fp32 key bias and promote, as jnp promotes
    # them, so the norms after the first attention take fp32 rows of bf16
    # parameters
    p_e16 = predictor(bf16=True)
    want = p_on.run(feed8)[0]
    for label, pred, flash, dtypes in (
            ("on", p_e16, {"bfloat16"}, {"bfloat16"}),
            ("off", predictor(ir=False, bf16=True), set(),
             {"bfloat16", "float32"})):
        reset_infer_counts()
        with LaunchDtypes() as seen:
            got16 = pred.run(feed8)[0]
        fa, ln, _, _ = infer_counts()
        rel = rel_norm(got16, want)
        if (fa, ln) != (n_layers if flash else 0, n_ln) or \
                seen.seen["flash_attention_fwd"] != flash or \
                seen.seen["layer_norm_fwd"] != dtypes or \
                not rel <= INFER_BF16_REL or got16.dtype != np.float32:
            fail(f"[inference] bf16, ir_optim {label}: launches {fa}/{ln} "
                 f"on {seen.seen}, relative norm {rel:.3e}")
        say("inference", f"(iv) enable_bf16 B=8, ir_optim {label}, vs fp32: "
            f"relative norm {rel:.3e} (tol {INFER_BF16_REL:g}); flash {fa} "
            f"and layer norm {ln} launches on {sorted(flash)} and "
            f"{sorted(dtypes)} instances; the fetch widened to "
            f"{got16.dtype}")

    # (vi) times
    p_b16 = predictor(bf16=True, buckets=INFER_LADDER)
    check_warmup(p_b16.warmup_buckets([f[:1] for f in feed8]), "bf16")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for label, pe, pb in (("fp32", p_on, p_b), ("bf16", p_e16, p_b16)):
        for b in INFER_TIME_B:
            f = bert_encoder_feed(b, seed=INFER_SEED + 90 + b,
                                  lo=POOL_MIN_LEN)
            eager = host_ms(lambda: pe.run(f))
            replay = host_ms(lambda: pb.run(f))
            dev = graph_device_ms(bucket_graph(pb, b))
            say("times", f"[inference] Predictor.run {label} B={b} "
                f"S={INFER_CFG['S']}: eager {eager:.2f} ms, graph replay "
                f"{replay:.2f} ms, device {dev:.3f} ms, "
                f"{b * INFER_CFG['S'] / replay * 1e3:.0f} tokens/s replayed"
                f"  [{card}]")
    reset_all()
    outs, lat, wall = drive_pool(pool, reqs)
    batches = stat_get("STAT_serving_batches")
    batch_p50 = timer_get("TIMER_serving_batch_us")["p50"] / 1e3
    # the device's busy time over the same traffic, from a profiled run;
    # the idle share is taken against the unprofiled run's wall time (the
    # profiler slows the host) and, as a bound, the profiled run's
    t0 = time.perf_counter()
    busy, n_k, _, _ = profile_step(lambda: drive_pool(pool, reqs))
    wall_p = time.perf_counter() - t0
    lat_s = sorted(lat)
    say("times", f"[inference] PredictorPool fp32, {len(reqs)} requests "
        f"({rows} rows, lengths {POOL_MIN_LEN}-{INFER_CFG['S']}) from "
        f"{POOL_THREADS} threads: {len(reqs) / wall:.1f} requests/s, "
        f"{rows / wall:.1f} rows/s, latency p50 "
        f"{lat_s[len(lat_s) // 2]:.2f} ms, p95 "
        f"{lat_s[int(0.95 * (len(lat_s) - 1))]:.2f} ms, "
        f"{int(batches)} batches, batch p50 {batch_p50:.2f} ms; device "
        f"busy {busy:.1f} ms in {n_k} kernels (profiled run of "
        f"{1e3 * wall_p:.1f} ms), idle share "
        f"{max(0.0, 1 - busy / (1e3 * wall)):.3f} of the unprofiled "
        f"{1e3 * wall:.1f} ms ({max(0.0, 1 - busy / (1e3 * wall_p)):.3f} of "
        f"the profiled run); peak memory {peak:.2f} GiB with "
        f"{len(p_b._graphs) + len(p_b16._graphs)} graphs  [{card}]")
    pool.close()
    kernel_times = time_infer_kernels(device, card)
    del pool, p_b, p_b16, p_on, p_off, p_e16
    gc.collect()
    torch.cuda.empty_cache()
    say("inference", f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return main_counts, kernel_times


# ---------------------------------------------------------------------------
# phase 10b: serving artifacts, warm starts and autotune
# ---------------------------------------------------------------------------

ARTIFACT_B = (1, 8)
# the generation engine's tune: a short probe, three geometry candidates
AUTOTUNE_CANDIDATES = 3
AUTOTUNE_PROBE_TOKENS = 32
AUTOTUNE_LADDER = "pow2:32"
DISPATCH_REPS = 200

# one child process serves the artifacts without the framework
# (paddle_tpu_torch, paddle_tpu and jax cannot be imported while it does),
# then lifts the bar and warm-starts a Predictor from the program cache.
# argv: a JSON job {"artifacts": {label: dir}, "feeds": npz, "out": npz
# prefix, "batches": [...], "reps": n, "warm": {"repo", "bundle", "cache",
# "ladder", "out"}}; prints an ARTIFACTS and a WARM JSON line
_SERVE_ARTIFACTS = r'''
import importlib.util, json, sys, time
BARRED = ("paddle_tpu_torch", "paddle_tpu", "jax")
for name in BARRED:
    sys.modules[name] = None
import numpy as np
import torch
job = json.loads(sys.argv[1])
with np.load(job["feeds"]) as f:
    feed8 = [f["f%d" % i] for i in range(len(f.files))]
report = {}
for label, art in job["artifacts"].items():
    spec = importlib.util.spec_from_file_location(
        "serving_core_" + label, art + "/serving_core.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t_art = time.perf_counter()
    core = mod.SerializedCore(art)
    rec = {"load_s": time.perf_counter() - t_art}
    for k in core.ops.launches:
        core.ops.launches[k] = 0
    core.run_eager(feed8)
    if core.device.type == "cuda":
        torch.cuda.synchronize()
    rec["launches"] = dict(core.ops.launches)
    outs = {}
    for b in job["batches"]:
        feed = [v[:b] for v in feed8]
        eager = core.run_eager(feed)
        cold = core.run(feed)          # the capture
        replay = core.run(feed)
        rec["b%d_bitwise" % b] = all(
            x.tobytes() == y.tobytes() for x, y in zip(eager, replay))
        rec["b%d_cold_bitwise" % b] = all(
            x.tobytes() == y.tobytes() for x, y in zip(eager, cold))
        for name, fn in (("eager", core.run_eager), ("replay", core.run)):
            times = []
            for _ in range(job["reps"]):
                t0 = time.perf_counter()
                fn(feed)
                times.append(1e3 * (time.perf_counter() - t0))
            rec["b%d_%s_ms" % (b, name)] = float(np.median(times))
        outs["%s_b%d" % (label, b)] = replay[0]
    rec["stats"] = dict(core.stats)
    rec["modules"] = sorted(m for m in sys.modules if sys.modules[m] is not
                            None and m.split(".")[0] in BARRED)
    rec["seconds"] = time.perf_counter() - t_art
    report[label] = rec
    np.savez(job["out"] + "_" + label + ".npz", **outs)
    del core
print("ARTIFACTS " + json.dumps(report), flush=True)

# the warm start: a Predictor of the cache that ran no pass and no export
warm = job["warm"]
for name in BARRED:
    del sys.modules[name]
sys.path.insert(0, warm["repo"])
t_import = time.perf_counter()
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch.monitor import stat_get
import paddle_tpu_torch.core.passes as passes
t_import = time.perf_counter() - t_import
def refuse(*a, **k):
    raise AssertionError("the warm start ran the pass pipeline or an export")
passes.apply_pass = TI.apply_pass = refuse
torch.export.export = refuse
cfg = TI.Config(warm["bundle"])
if torch.cuda.is_available():
    cfg.enable_use_gpu()
    torch.cuda.synchronize()
else:
    cfg.disable_gpu()
t0 = time.perf_counter()
cfg.switch_shape_bucketing(True, buckets=warm["ladder"])
cfg.enable_program_cache(warm["cache"])
p = TI.create_predictor(cfg)
if p.device.type == "cuda":
    torch.cuda.synchronize()
t_build = time.perf_counter() - t0
np.save(warm["out"], p.run(feed8)[0])
print("WARM " + json.dumps({
    "construct_s": t_build, "import_s": t_import, "hit": p.cache_hit,
    "program": p.program is None,
    "trace_hit": stat_get("STAT_program_cache_trace_hit"),
    "bytes_read": stat_get("STAT_program_cache_bytes_read")}))
'''


def _json_line(stdout, tag, what):
    for line in stdout.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    fail(f"[artifact] {what} printed no {tag} line")


def _tree_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _child(cmd, what, env=None, cwd=None, timeout=300):
    """Run a child process to its end; fail with its output if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=timeout)
    if proc.returncode != 0:
        fail(f"[artifact] {what} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def time_dispatch(device, card, reps=DISPATCH_REPS):
    """Host microseconds a call of each kernel op over its wrapper's
    direct launch, at the serving forward's shapes (B=8 S=128 fp32),
    ``reps`` calls each in turns, ending in a synchronize. Launches made
    here are not on a main path."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.kernels import traced
    traced.register()
    ops = torch.ops.paddle_tpu
    b, s, h, d = 8, INFER_CFG["S"], INFER_CFG["heads"], 64
    x, g, bt = ln_inputs(b * s, h * d, torch.float32, device, 4242)
    qkv = torch.randn(b, s, 3, h, d, device=device)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = padding_bias(b, s, device, 4243, lo=POOL_MIN_LEN)
    scale = 1.0 / math.sqrt(d)
    cases = {
        "layer_norm_fwd": (lambda: LN._launch(x, g, bt, 1e-5),
                           lambda: ops.layer_norm_fwd(x, g, bt, 1e-5)),
        "flash_attention_fwd": (
            lambda: FA._launch_fwd(q, k, v, bias, False, scale, None, None,
                                   1.0),
            lambda: ops.flash_attention_fwd(q, k, v, bias, False, scale)),
    }
    out = {}
    for name, (direct, op) in cases.items():
        us = {"direct": [], "op": []}
        for _ in range(2):
            for form, fn in (("direct", direct), ("op", op),
                             ("op", op), ("direct", direct)):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                us[form].append(1e6 * (time.perf_counter() - t0) / reps)
        out[name] = (min(us["direct"]), min(us["op"]))
        say("times", f"[artifact] dispatch of {name}: wrapper's launch "
            f"{out[name][0]:.2f} us a call, custom op {out[name][1]:.2f} us "
            f"a call (+{out[name][1] - out[name][0]:.2f} us; best of 4 runs "
            f"of {reps} calls, host clock)  [{card}]")
    return out


def run_artifact(device, card, bundle):
    """Phase 10b: the BERT-base encoder bundle that phase 10 saved into the
    directory ``bundle``, as serving artifacts. (i) a cold Predictor of the program cache exports
    its forward (a dynamic batch, no weights) and serves the module it
    read back; export fp32 with a static batch (8) and a dynamic one, both
    over that module, and bf16 (static 8, from the bf16 Predictor's
    program); (ii) one child process serves all three while it cannot
    import the port, with the kernels' launches counted there (12 flash
    and 25 layer-norm forwards in one forward), each against the
    Predictor's output (bf16 bitwise) and each replay bitwise against its
    eager run, the times beside the Predictor's; then (iii) the same
    process warm-starts a Predictor from the cache, bitwise against the
    cold one; (iv) serve from the C client; (v) autotune the Predictor's
    bucket choice and (vi) the generation engine at docs/generation.md:19's
    decoder; (vii) the custom ops' dispatch cost. Prints each step's
    seconds. Returns the main path's launches (flash forward, layer-norm
    forward): the artifact process's, counted there."""
    import sysconfig

    from paddle_tpu_torch import autotune as AT
    from paddle_tpu_torch import capi
    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch.monitor import reset_all, stat_get
    t_phase = time.perf_counter()
    steps = {}
    t_step = time.perf_counter()

    def step(name):
        nonlocal t_step
        now = time.perf_counter()
        steps[name] = now - t_step
        t_step = now

    n_layers = INFER_CFG["layers_n"]
    n_ln = 2 * n_layers + 1
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name

    def config(bf16=False, cache=None, ladder=None, autotune=False):
        cfg = TI.Config(bundle)
        cfg.enable_use_gpu(device_id=device.index or 0)
        if bf16:
            cfg.enable_bf16()
        if cache:
            cfg.enable_program_cache(cache)
        if ladder:
            cfg.switch_shape_bucketing(True, buckets=ladder)
        cfg.switch_autotune(autotune)
        return cfg

    feed8 = bert_encoder_feed(8, lo=POOL_MIN_LEN)
    np.savez(os.path.join(root, "feed8.npz"),
             **{f"f{i}": v for i, v in enumerate(feed8)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p32 = TI.create_predictor(config())
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    want = {b: p32.run([v[:b] for v in feed8])[0] for b in ARTIFACT_B}
    p16 = TI.create_predictor(config(bf16=True))
    want16 = p16.run(feed8)[0]
    # p16 widens its bf16 fetch to fp32 exactly: its raw words
    words16 = (want16.view(np.uint32) >> 16).astype(np.uint16)
    step("plain Predictors")

    # (i) the cold Predictor of the cache exports the dynamic forward
    # without weights at construction, and serves (and captures its bucket
    # graphs over) the module it read back
    cache = os.path.join(root, "cache")
    reset_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = TI.create_predictor(config(cache=cache, ladder=list(ARTIFACT_B)))
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    entry_bytes = stat_get("STAT_program_cache_bytes_written")
    if cold.cache_hit or cold._module is None or entry_bytes <= 0:
        fail(f"[artifact] the cold Predictor did not write and load the "
             f"cache (hit {cold.cache_hit}, module "
             f"{cold._module is not None})")
    step("cold Predictor")
    arts, sigs, t_export = {}, {}, {}
    for label, pred, dyn in (("fp32_static", cold, False),
                             ("fp32_dynamic", cold, True),
                             ("bf16_static", p16, False)):
        arts[label] = os.path.join(root, label)
        t0 = time.perf_counter()
        sigs[label] = pred.export_serialized(arts[label], feed8,
                                             dynamic_batch=dyn)
        t_export[label] = time.perf_counter() - t0
        ops = sigs[label]["kernel_ops"]
        shipped = sorted(f for f in os.listdir(os.path.join(arts[label],
                                                            "kernels"))
                         if f.endswith(".so"))
        if ops != {"layer_norm_fwd": n_ln, "flash_attention_fwd": n_layers} \
                or shipped != ["libflash_attention.so", "liblayer_norm.so"]:
            fail(f"[artifact] {label}: kernel ops {ops}, libraries {shipped}")
        say("artifact", f"(i) export {label}: {t_export[label]:.2f} s"
            + (" (over the cached module)" if pred is cold else
               " (the executor's forward)")
            + f", {_tree_bytes(arts[label]) / 2 ** 20:.1f} MiB (model.pt2 "
            f"{os.path.getsize(os.path.join(arts[label], 'model.pt2')) / 2 ** 20:.1f}"
            f" MiB); graph calls {ops}; batch {sigs[label]['batch']}")
    step("exports")
    say("artifact", f"(i) Predictor construction: plain {t_plain:.2f} s, "
        f"cold with the program cache {t_cold:.2f} s (load, passes, "
        f"export without weights, store {entry_bytes / 2 ** 20:.2f} MiB, "
        f"read back)  [{card}]")

    # (ii) the artifacts from a process without the framework, then (iii)
    # a warm start in that process once it lifts the bar
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = os.path.join(root, "serve.py")
    with open(script, "w") as f:
        f.write(_SERVE_ARTIFACTS)
    warm_out = os.path.join(root, "warm.npy")
    job = dict(artifacts=arts, feeds=os.path.join(root, "feed8.npz"),
               out=os.path.join(root, "served"), batches=list(ARTIFACT_B),
               reps=10, warm=dict(
                   repo=os.path.dirname(os.path.abspath(__file__)),
                   bundle=bundle, cache=cache, ladder=list(ARTIFACT_B),
                   out=warm_out))
    t0 = time.perf_counter()
    stdout = _child([sys.executable, script, json.dumps(job)],
                    "the artifact process", env=env, cwd=root)
    t_served = time.perf_counter() - t0
    served = _json_line(stdout, "ARTIFACTS", "the artifact process")
    warm = _json_line(stdout, "WARM", "the artifact process")
    counts = (0, 0)
    for label, rec in served.items():
        outs = np.load(os.path.join(root, f"served_{label}.npz"))
        lau = rec["launches"]
        if lau != {"layer_norm_fwd": n_ln, "flash_attention_fwd": n_layers}:
            fail(f"[artifact] {label}: one forward launched {lau}")
        if rec["modules"]:
            fail(f"[artifact] {label}: the process imported {rec['modules']}")
        bad = [b for b in ARTIFACT_B if not rec[f"b{b}_bitwise"] or
               not rec[f"b{b}_cold_bitwise"]]
        if bad:
            fail(f"[artifact] {label}: replays differ from the eager run at "
                 f"batches {bad}")
        if label.startswith("fp32"):
            errs = [check_close(f"{label} B={b}", outs[f"{label}_b{b}"],
                                want[b]) for b in ARTIFACT_B]
            agree = f"max error {max(errs):.3e} against the Predictor"
        else:
            words = outs[f"{label}_b8"]
            if words.dtype != np.uint16 or \
                    words.tobytes() != words16.tobytes():
                fail(f"[artifact] {label}: {words.dtype} words not bitwise "
                     f"the bf16 Predictor's (relative norm "
                     f"{rel_norm((words.astype(np.uint32) << 16).view(np.float32), want16):.3e})")
            agree = "raw bf16 words bitwise the bf16 Predictor's"
        counts = (counts[0] + lau["flash_attention_fwd"],
                  counts[1] + lau["layer_norm_fwd"])
        say("artifact", f"(ii) {label} served without the framework "
            f"(loaded in {rec['load_s']:.2f} s, served in "
            f"{rec['seconds']:.2f} s): one eager forward launched "
            f"flash {lau['flash_attention_fwd']}, layer norm "
            f"{lau['layer_norm_fwd']}; {agree}; every replay bitwise its "
            f"eager run; graphs {rec['stats']['graph_captures']}, replays "
            f"{rec['stats']['graph_replays']}")
        say("times", f"[artifact] SerializedCore {label} S={INFER_CFG['S']}: "
            + ", ".join(f"B={b} eager {rec[f'b{b}_eager_ms']:.2f} ms, replay "
                        f"{rec[f'b{b}_replay_ms']:.2f} ms"
                        for b in ARTIFACT_B) + f"  [{card}]")
    cold8 = cold.run(feed8)[0]
    if not warm["hit"] or not warm["program"] or warm["trace_hit"] != 1 or \
            np.load(warm_out).tobytes() != cold8.tobytes():
        fail(f"[artifact] the warm start: {warm}; bitwise "
             f"{np.load(warm_out).tobytes() == cold8.tobytes()}")
    say("artifact", f"(iii) warm Predictor in a fresh process: built in "
        f"{warm['construct_s']:.2f} s from the cache "
        f"({warm['bytes_read'] / 2 ** 20:.2f} MiB read, the parameters "
        f"from the bundle; no pass, no export) against {t_cold:.2f} s cold "
        f"and {t_plain:.2f} s without the cache; B=8 bitwise the cold one  "
        f"[{card}]")
    say("artifact", f"(ii) the artifact process took {t_served:.1f} s "
        f"(the port's import for the warm start {warm['import_s']:.2f} s)")
    step("artifact process")
    # the Predictor at the same shapes: eager (no ladder) and its replay
    # (the cold Predictor's graphs, captured over the cached module)
    check_warmup(cold.warmup_buckets([v[:1] for v in feed8]),
                 "the cached module")
    for b in ARTIFACT_B:
        f = [v[:b] for v in feed8]
        got = cold.run(f)[0]
        if got.tobytes() != cold._eager(dict(zip(cold.feed_names,
                                                f)))[0].tobytes():
            fail(f"[artifact] the cached module's replay at B={b} differs "
                 "from its eager run")
        say("times", f"[artifact] Predictor B={b} S={INFER_CFG['S']}: eager "
            f"{host_ms(lambda: p32.run(f)):.2f} ms, replay over the cached "
            f"module {host_ms(lambda: cold.run(f)):.2f} ms  [{card}]")
    del cold
    step("Predictor times")

    # (iv) the C client
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        say("artifact", "(iv) this Python has no shared libpython "
            "(Py_ENABLE_SHARED off): the C ABI cannot embed it; not run")
    else:
        t0 = time.perf_counter()
        client = capi.client()
        t_build = time.perf_counter() - t0
        ind, outd = os.path.join(root, "c_in"), os.path.join(root, "c_out")
        os.makedirs(ind)
        os.makedirs(outd)
        for i, v in enumerate(feed8):
            capi.write_tensor(os.path.join(ind, f"in{i}.bin"), v)
        reps = 21
        stdout = _child([str(client), arts["fp32_static"], "--raw", ind,
                         outd, str(reps)], "the C client", env=env, cwd=root)
        ms = float(re.search(r"MS_PER_RUN ([0-9.]+)", stdout).group(1))
        got = capi.read_tensor(os.path.join(outd, "out0.bin"))
        ref = np.load(os.path.join(root, "served_fp32_static.npz"))[
            "fp32_static_b8"]
        if got.tobytes() != ref.tobytes():
            fail("[artifact] the C client's output differs from "
                 "SerializedCore's")
        say("artifact", f"(iv) C client (built in {t_build:.1f} s): B=8 "
            f"bitwise SerializedCore's; {ms:.3f} ms a request over {reps - 1} "
            f"runs after the first  [{card}]")
    step("C client")

    # (v) autotune: the Predictor's bucket-or-exact choice at B=3
    AT.reset()
    t0 = stat_get("STAT_autotune_trials")
    pa = TI.create_predictor(config(ladder=AUTOTUNE_LADDER, autotune=True))
    f3 = [v[:3] for v in feed8]
    pa.run(f3)
    snap = [s for s in AT.policies() if s["kind"] == "predictor"]
    entry, = AT.policy().entries()
    if not snap or stat_get("STAT_autotune_trials") - t0 != 6:
        fail(f"[artifact] the Predictor's tune: {snap}")
    say("artifact", f"(v) Predictor autotune at B=3 on {AUTOTUNE_LADDER}: "
        f"6 trials, winner {snap[0]['form']!r}; " + ", ".join(
            f"{c['label']} {c['step_time_us'] / 1e3:.2f} ms (bitwise the "
            f"bucket's: {c['eligible']})" for c in entry["candidates"])
        + f"  [{card}]")
    del pa, p32, p16
    step("Predictor autotune")

    # (vi) autotune of the generation engine at full width
    gen = run_gen_autotune(device, card, os.path.join(root, "gen_policy"))
    step("engine autotune")
    dispatch = time_dispatch(device, card)
    gc.collect()
    torch.cuda.empty_cache()
    tmp.cleanup()
    step("dispatch")
    say("artifact", "step costs: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in steps.items()))
    say("artifact", f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return counts, gen, dispatch


def run_gen_autotune(device, card, cache):
    """Autotune of docs/generation.md:19's 16-layer decoder: geometry only
    on the card (block size x prefill chunk; the kernel is the Hopper one),
    a short probe, the winner stored and reloaded by a fresh engine with
    no trial; kernel="reference" on the card raises."""
    from paddle_tpu_torch import autotune as AT
    from paddle_tpu_torch.flags import set_flags, clear_explicit, get_flag
    from paddle_tpu_torch.generation import (DecoderConfig, GenerationEngine,
                                             init_params)
    from paddle_tpu_torch.jit import load_reference_params
    from paddle_tpu_torch.monitor import stat_get
    cfg = DecoderConfig(**GEN_CFG)
    params = load_reference_params(cfg, init_params(cfg, GEN_SEED), device)
    geo = {k: v for k, v in GEN_GEO.items()
           if k not in ("block_size", "prefill_chunk")}
    saved = {k: get_flag(k) for k in ("FLAGS_autotune_candidates",
                                      "FLAGS_autotune_probe_tokens",
                                      "FLAGS_generation_block_size",
                                      "FLAGS_generation_prefill_chunk")}
    set_flags({"FLAGS_autotune_candidates": AUTOTUNE_CANDIDATES,
               "FLAGS_autotune_probe_tokens": AUTOTUNE_PROBE_TOKENS,
               "FLAGS_generation_block_size": GEN_GEO["block_size"],
               "FLAGS_generation_prefill_chunk": GEN_GEO["prefill_chunk"]})
    clear_explicit(*saved)
    try:
        try:
            GenerationEngine(cfg, params, kernel="reference", device=device,
                             **GEN_GEO)
            fail("[artifact] kernel='reference' on the card did not raise")
        except ValueError as e:
            if "ROADMAP.md" not in str(e):
                fail(f"[artifact] kernel='reference' raised {e}")
        AT.reset()
        t0 = time.perf_counter()
        trials = stat_get("STAT_autotune_trials")
        eng = GenerationEngine(cfg, params, autotune=True,
                               program_cache_dir=cache, device=device, **geo)
        t_tune = time.perf_counter() - t0
        entry = eng._policy_entry
        n = stat_get("STAT_autotune_trials") - trials
        cands = entry["candidates"]
        if entry["source"] != "tuned" or n != len(cands) or \
                {c["kernel"] for c in cands} != {"pallas"} or \
                not cands[0]["eligible"]:
            fail(f"[artifact] the engine's tune: {entry}")
        default = cands[0]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        AT.reset()
        trials = stat_get("STAT_autotune_trials")
        hits = stat_get("STAT_autotune_cache_hits")
        again = GenerationEngine(cfg, params, autotune=True,
                                 program_cache_dir=cache, device=device,
                                 **geo)
        if stat_get("STAT_autotune_trials") != trials or \
                stat_get("STAT_autotune_cache_hits") != hits + 1 or \
                again._policy_entry["label"] != entry["label"] or \
                (again.kv.block_size, again.prefill_chunk) != \
                (entry["block_size"], entry["prefill_chunk"]):
            fail(f"[artifact] a fresh engine did not reload the winner: "
                 f"{again._policy_entry}")
        say("artifact", f"(vi) engine autotune, decoder {GEN_CFG}: {int(n)} "
            f"trials in {t_tune:.1f} s (probe {AUTOTUNE_PROBE_TOKENS} tokens, "
            f"3 interleaved passes), winner {entry['label']} at "
            f"{entry['us_per_token']:.0f} us a token "
            f"({entry['step_time_us']:.0f} us a step) against the default {default['label']} at "
            f"{default['us_per_token']:.0f} us a token; " + ", ".join(
                f"{c['label']} {c.get('us_per_token', 0):.0f} us/token "
                f"eligible {c['eligible']}" for c in cands) +
            "; a fresh engine reloaded it with 0 trials; kernel='reference' "
            f"on the card raised  [{card}]")
        del again
        return entry
    finally:
        set_flags(saved)
        clear_explicit(*saved)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: static-graph training
# ---------------------------------------------------------------------------

# form (d): form (c)'s forward, multihead_matmul_fuse on it, then static
# mixed precision with the fused attention on the white list
AMP_WHITE = ("multihead_matmul",)


def amp_form(pt, dtype="bfloat16", cfg=STATIC_CFG, recompute=False,
             init_loss_scaling=None, unfreeze_packed=False, white=AMP_WHITE):
    """Form (d) built with package ``pt``: build_bert_forward with
    begin_norm_axis 2, multihead_matmul_fuse on the forward-only program,
    then ``contrib.mixed_precision.decorate(Adam(STATIC_LR),
    AutoMixedPrecisionLists(custom_white_list=white), dest_dtype=dtype)``
    minimized: dynamic loss scaling for float16 only, from
    ``init_loss_scaling`` (2^15 when None). ``recompute`` sets the backward
    op's remat_segments from checkpoints at each layer's output, as
    ``append_backward(checkpoints=)`` records them (decorate's minimize
    takes no checkpoints). ``unfreeze_packed`` clears the stop_gradient
    that the JAX package's fuse pass puts on the packed weights and biases
    (ROADMAP.md C2), so that both packages train them. Returns (main,
    startup, loss name) and the names of the loss scale and of the
    good/bad step counters (None without dynamic scaling)."""
    import importlib
    passes = importlib.import_module(pt.__name__ + ".core.passes")
    backward = importlib.import_module(pt.__name__ + ".core.backward")
    mp = pt.contrib.mixed_precision
    main, startup, loss, outs = build_bert_forward(pt, **cfg, norm_axis=2)
    startup.random_seed = STATIC_SEED
    main = passes.apply_pass(main, "multihead_matmul_fuse")
    if unfreeze_packed:
        for v in main.global_block.vars.values():
            if v.name.startswith("mha_fuse_") and "_xs_" not in v.name:
                v.stop_gradient = False
    kw = {} if init_loss_scaling is None else dict(
        init_loss_scaling=init_loss_scaling)
    opt = mp.decorate(pt.optimizer.Adam(STATIC_LR),
                      mp.AutoMixedPrecisionLists(custom_white_list=list(
                          white)), dest_dtype=dtype, **kw)
    with pt.program_guard(main, startup):
        opt.minimize(loss, startup_program=startup, program=main)
    if recompute:
        op = next(op for op in main.global_block.ops
                  if op.type == "backward")
        op.attrs["remat_segments"] = backward._segments_from_checkpoints(
            main.global_block, outs)
    persist = [v.name for v in main.persistable_vars()]
    counter = (lambda prefix: next((n for n in persist
                                    if n.startswith(prefix)), None))
    return (main, startup, loss.name), dict(
        scale=opt.get_loss_scaling(), good=counter("good_steps"),
        bad=counter("bad_steps"))


def norm_cast_variant(pt, dtype="bfloat16", cfg=STATIC_CFG):
    """Form (d)'s wrong variant: the residual adds on the white list too,
    and the casts to float32 that rewrite_program puts before each
    layer_norm (a black-list op) taken out, so that the norms take
    ``dtype`` rows. Returns amp_form's (form, names)."""
    form, names = amp_form(pt, dtype, cfg,
                           white=AMP_WHITE + ("elementwise_add",))
    blk = form[0].global_block
    made = {op.output("Out")[0]: op for op in blk.ops if op.type == "cast"}
    for op in list(blk.ops):
        cast = made.get(op.input("X")[0]) if op.type == "layer_norm" \
            else None
        if cast is not None:
            op.inputs["X"] = list(cast.input("X"))
            blk.ops.remove(cast)
    return form, names


def amp_program_faults(main, dtype):
    """What in a rewritten program breaks form (d)'s plan of precisions: a
    layer_norm fed other than float32 rows, a multihead_matmul input
    other than ``dtype``."""
    blk = main.global_block
    faults = []
    for op in blk.ops:
        want = {"layer_norm": "float32", "multihead_matmul": dtype}.get(
            op.type)
        names = op.input("X") if op.type == "layer_norm" else \
            op.input_names()
        faults += [f"{op.type} reads {n} in {blk.var(n).dtype}"
                   for n in (names if want else ())
                   if blk.var(n).dtype != want]
    return faults


def last_layer_grads(main):
    """The @GRAD names of the parameters that the last layer of a
    BERT-shaped program reads: a parameter belongs to layer (layer_norm
    ops before its first reader) // 2, two norms a layer. Near the loss
    two runs of one bf16 program meet few roundings of their own, a run
    in another precision all of its own roundings."""
    blk = main.global_block
    norms, layer_of = 0, {}
    for op in blk.ops:
        if op.type == "backward":
            break
        for n in op.input_names():
            if n in blk.vars and blk.var(n).is_parameter:
                layer_of.setdefault(n, norms // 2)
        norms += op.type == "layer_norm"
    last = max(layer_of.values())
    return [n + "@GRAD" for n, layer in layer_of.items()
            if layer == last and n + "@GRAD" in blk.vars]


# Fluid's MNIST LeNet: examples/fluid_mnist.py at its own widths and batch
LENET_B = 64
LENET_STEPS = 10
LENET_LR = 1e-3
LENET_SEED = 42
# the update rules and the recipe on LeNet, card against the CPU port:
# steps a rule, each step's loss, lr, gradients (after the clip where
# there is one), and every persistable after it
RULE_STEPS = 3
# LeNet in fp32 on the card (cuDNN's convolutions, TF32 off) against the
# CPU port: the loss within 1e-5 relative; each gradient within STEP_TOL
# (1e-4 of its max plus 1e-4 relative, a floor of 1e-5 of the largest
# gradient); each persistable after a step within 2.5 lr of the CPU's
# and, per tensor, its change within UPDATE_RTOL of the CPU's change in
# the 2-norm. Moment-free rules (SGD, Lookahead's sync) move by lr g, the
# adaptive ones by ~lr whatever |g|. The lr var is held exactly: both
# sides compute it from the same integer step.
# form (d) against the CPU port's run of the same program and against the
# card's fp32 form (c): the loss within AMP_LOSS_RTOL and the gradients
# within AMP_GRAD_REL of their dtype in the 2-norm over all of them (less
# the key biases, whose exact gradient is 0); against the CPU port also
# the last layer's gradients (last_layer_grads) within AMP_LAST_REL. Two
# runs of one bf16 program in other orders differ by bf16 rounding steps
# wherever an intermediate lands on another side of one. Measured on one
# H100 at 700 W (phase 11 alone, B=2 against the CPU port): bf16 0.00331
# over all, 0.00292 the last layer; fp16 0.00035, 0.00028; (d) against
# (c) at B=8 0.00614 bf16, 0.00075 fp16. AMP_LAST_REL lies between these
# and the control that must fail it, the card's fp32 (c) against the CPU
# port's (d): 0.00609 bf16, 0.00066 fp16 in the last layer. What one step
# cannot see: norm_cast_variant, the norms on bf16 rows, read 0.00446 over
# all and 0.00415 in the last layer (the card's norm kernels compute in
# fp32 whatever their rows), inside both limits; the program guard
# (amp_program_faults) and the launch-dtype guard (launch_dtype_faults)
# are what reject it. AMP_GRAD_REL's control is fp16 with its loss scale
# started at 1, whose backward underflows (the mean's gradient is
# 1/(B S H), 1.3e-6 at B=8, below fp16's normal range): 0.072 at B=2, 0.21
# at B=8 on the card; at 2 layers of 128 on the CPU it does not underflow.
AMP_GRAD_REL = {"bfloat16": 1e-2, "float16": 2e-3}
AMP_LOSS_RTOL = 1e-2
AMP_LAST_REL = {"bfloat16": 4.2e-3, "float16": 4.3e-4}
# fp16 with dynamic loss scaling: ten steps from 2^15; then a run from a
# loss scale at which the fp16 backward overflows (2^32, raised to 2^36 and
# 2^40 if a step does not), OVERFLOW_STEPS steps at B=OVERFLOW_B on the card
# and on the CPU port: two overflows halve the scale
# (decr_every_n_nan_or_inf 2). The CPU port's fp16 step of the 12 layers
# is slow on the card's host (measured beside one H100: 140.8 s for three
# steps at B=2 on both sides, 113.0 s for two).
OVERFLOW_STEPS = 2
OVERFLOW_B = 1


def lenet_network(fluid, img, label):
    """examples/fluid_mnist.py's ``network`` (:18-30) over the ``fluid``
    namespace it is given."""
    conv1 = fluid.nets.simple_img_conv_pool(
        img, num_filters=20, filter_size=5, pool_size=2, pool_stride=2,
        act="relu")
    conv2 = fluid.nets.simple_img_conv_pool(
        conv1, num_filters=50, filter_size=5, pool_size=2,
        pool_stride=2, act="relu")
    pred = fluid.layers.fc(conv2, 10, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
    acc = fluid.layers.accuracy(pred, label)
    return loss, acc


def build_lenet(fluid, opt=None):
    """The example's program: [1, 28, 28] images and int64 labels through
    ``lenet_network``, minimized by ``opt(fluid)`` (Adam(1e-3) by
    default). Returns (main, startup, loss name), the accuracy var and the
    optimizer."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = LENET_SEED
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [1, 28, 28])
        label = fluid.layers.data("label", [1], dtype="int64")
        loss, acc = lenet_network(fluid, img, label)
        optimizer = (opt or (lambda f: f.optimizer.Adam(LENET_LR)))(fluid)
        optimizer.minimize(loss, startup_program=startup, program=main)
    return (main, startup, loss.name), acc, optimizer


def lenet_feeds(b, n, fluid=None, datasets=None):
    """The first ``n`` batches of the MNIST reader's synthetic corpus, as
    the example feeds them: reader.batch, each sample reshaped to [1, 28,
    28], DataFeeder."""
    if fluid is None:
        from paddle_tpu_torch import datasets, fluid
    feeder = fluid.DataFeeder(["img", "label"])
    feeds = []
    for batch in fluid.io.batch(datasets.mnist.train(), b)():
        feeds.append(feeder.feed([
            (np.asarray(x, np.float32).reshape(1, 28, 28),
             np.asarray([y], np.int64)) for x, y in batch]))
        if len(feeds) == n:
            break
    return feeds


def program_steps(form, state, device, feeds, fetch=(), steps=1, keep=None):
    """``steps`` steps of (main, startup, loss) on ``device`` from a numpy
    state: each step's loss and ``fetch`` (CPU tensors) and every
    persistable after it (those named in ``keep`` when given); and the
    executor."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import load_reference_scope
    main, _, loss = form
    scope = pt.Scope()
    load_reference_scope(scope, state, device)
    exe = pt.Executor(device)
    out = []
    for i in range(steps):
        vals = exe.run(main, feed=feeds[i % len(feeds)],
                       fetch_list=[loss, *fetch], scope=scope,
                       return_numpy=False)
        out.append(dict(
            loss=float(vals[0]),
            fetch={n: v.detach().cpu() for n, v in zip(fetch, vals[1:])},
            after={v.name: scope.find_var(v.name).detach().cpu().clone()
                   for v in main.persistable_vars()
                   if (keep is None or v.name in keep) and
                   isinstance(scope.find_var(v.name), torch.Tensor)}))
    return out, exe


def hold_steps(label, card, cpu, state, lr):
    """Each step of ``card`` against ``cpu`` (program_steps' records): the
    loss, every fetched value (the lr exactly, gradients at STEP_TOL) and
    every persistable after it (2.5 lr; float tensors' changes within
    UPDATE_RTOL in norm). Returns the worst shares of the
    tolerances."""
    worst = dict(grad=0.0, param=0.0, update=0.0)
    for i, (g, c) in enumerate(zip(card, cpu)):
        if not math.isfinite(g["loss"]) or abs(g["loss"] - c["loss"]) > \
                1e-5 * abs(c["loss"]) + 1e-7:
            fail(f"{label} step {i + 1}: loss {g['loss']} on the card, "
                 f"{c['loss']} on the CPU port")
        fetched = c["fetch"]
        top = max([float(t.abs().max()) for n, t in fetched.items()
                   if t.is_floating_point() and t.dim()] + [0.0])
        for n, want in fetched.items():
            got = g["fetch"][n]
            if not want.is_floating_point() or not want.dim():
                if not torch.equal(got, want):
                    fail(f"{label} step {i + 1}: {n} {got} on the card, "
                         f"{want} on the CPU port")
                continue
            atol = STEP_TOL["grad_rel"] * float(want.abs().max()) + \
                STEP_TOL["grad_floor"] * top
            e, ok = max_err(got, want, atol, STEP_TOL["grad_rel"])
            worst["grad"] = max(worst["grad"], e / max(atol, 1e-30))
            if not ok:
                fail(f"{label} step {i + 1}: {n} differs by {e} (max "
                     f"|ref| {float(want.abs().max())})")
        before = cpu[i - 1]["after"] if i else {
            n: torch.from_numpy(np.array(v)) for n, v in state.items()}
        for n, want in c["after"].items():
            got = g["after"][n]
            if not want.is_floating_point():
                if not torch.equal(got, want):
                    fail(f"{label} step {i + 1}: {n} {got} on the card, "
                         f"{want} on the CPU port")
                continue
            e, ok = max_err(got, want, 2.5 * lr, 0.0)
            worst["param"] = max(worst["param"], e / (2.5 * lr))
            if not ok:
                fail(f"{label} step {i + 1}: {n} after the step differs by "
                     f"{e} (tol 2.5 lr)")
            if n not in before or ".k_b_" in n:
                continue
            gb = card[i - 1]["after"][n] if i else before[n]
            d_g = got.double() - gb.double()
            d_c = want.double() - before[n].double()
            if float(d_c.norm()) == 0.0 and float(d_g.norm()) == 0.0:
                continue
            rel = float((d_g - d_c).norm()) / max(float(d_c.norm()), 1e-30)
            worst["update"] = max(worst["update"], rel / UPDATE_RTOL)
            if not rel <= UPDATE_RTOL:
                fail(f"{label} step {i + 1}: the change of {n} is {rel:.3e} "
                     f"of its norm away (tol {UPDATE_RTOL:g})")
    return worst


def check_lenet(device, card):
    """(1) LeNet through the port's fluid under CUDAPlace(0) at B=64: one
    step against the CPU port (loss, every @GRAD, every persistable
    after), then LENET_STEPS Adam steps on the corpus, each op lowered
    once a step, the loss falling and the accuracy fetched."""
    from paddle_tpu_torch import fluid
    form, acc, _ = build_lenet(fluid)
    main = form[0]
    state = static_state(form[1], fluid.CPUPlace())
    feeds = lenet_feeds(LENET_B, LENET_STEPS)
    grads = [n for n in main.global_block.vars if n.endswith("@GRAD")]
    place = fluid.CUDAPlace(0)
    g, _ = program_steps(form, state, place, feeds, grads)
    c, _ = program_steps(form, state, fluid.CPUPlace(), feeds, grads)
    worst = hold_steps("static-train LeNet", g, c, state, LENET_LR)
    say("static-train", f"LeNet (examples/fluid_mnist.py) on CUDAPlace(0) "
        f"vs CPUPlace(), B={LENET_B}: loss {g[0]['loss']:.7f} / "
        f"{c[0]['loss']:.7f}; {len(grads)} @GRAD at {worst['grad']:.3f} of "
        f"STEP_TOL; persistables within {worst['param']:.3f} of 2.5 lr, "
        f"changes at {worst['update']:.3f} of {UPDATE_RTOL:g}")
    import collections
    runs, exe = program_steps(form, state, place, feeds, [acc.name],
                              steps=LENET_STEPS)
    losses = [r["loss"] for r in runs]
    accs = [float(r["fetch"][acc.name]) for r in runs]
    want = collections.Counter(op.type for op in main.global_block.ops)
    if exe.lowered != want:
        fail(f"LeNet: lowerings {dict(exe.lowered)} against the program's "
             f"ops {dict(want)}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"LeNet on the card: losses {losses}")
    say("static-train", f"LeNet {LENET_STEPS} Adam({LENET_LR:g}) steps on "
        f"the synthetic MNIST corpus, B={LENET_B}, {card}: losses "
        + " ".join(f"{v:.4f}" for v in losses) + "; accuracy "
        + " ".join(f"{v:.3f}" for v in accs) + f"; each of the "
        f"{len(main.global_block.ops)} ops lowered once a step")


def rule_optimizers():
    """{name: (opt(fluid), lr)}: the nine newly ported update rules, the
    Lookahead wrapper and the two recipes (clip, decay, warmup into a
    polynomial decay)."""
    def recipe(which):
        def make(fluid):
            O = fluid.optimizer
            sched = O.LinearLrWarmup(
                O.PolynomialDecay(1e-3, decay_steps=20,
                                  end_learning_rate=0.0), warmup_steps=2,
                start_lr=1e-4, end_lr=1e-3)
            clip = fluid.clip.GradientClipByGlobalNorm(1.0)
            reg = fluid.regularizer.L2Decay(1e-4)
            if which == "adamw":
                return O.AdamW(sched, weight_decay=0.01, grad_clip=clip,
                               regularization=reg)
            return O.Lamb(sched, lamb_weight_decay=0.01, grad_clip=clip,
                          regularization=reg)
        return make
    return {
        "lamb": (lambda f: f.optimizer.Lamb(1e-3), 1e-3),
        "lars_momentum": (lambda f: f.optimizer.LarsMomentum(
            0.1, lars_weight_decay=5e-4), 0.1),
        "adagrad": (lambda f: f.optimizer.Adagrad(1e-2), 1e-2),
        "decayed_adagrad": (lambda f: f.optimizer.DecayedAdagrad(1e-2),
                            1e-2),
        "adamax": (lambda f: f.optimizer.Adamax(1e-3), 1e-3),
        "adadelta": (lambda f: f.optimizer.Adadelta(1.0), 1e-2),
        "rmsprop_centered": (lambda f: f.optimizer.RMSProp(
            1e-3, momentum=0.9, centered=True), 1e-2),
        "ftrl": (lambda f: f.optimizer.Ftrl(1e-2, l1=1e-4, l2=1e-4), 1e-2),
        "dpsgd": (lambda f: f.optimizer.DpSGD(1e-2, clip=1.0,
                                              batch_size=64.0, sigma=1.0),
                  1e-2),
        "lookahead_sgd_k2": (lambda f: f.optimizer.LookaheadOptimizer(
            f.optimizer.SGD(0.1), alpha=0.5, k=2), 0.1),
        "adamw_clip_l2_warmup_poly": (recipe("adamw"), 1e-3),
        "lamb_clip_l2_warmup_poly": (recipe("lamb"), 1e-3),
    }


def check_rules(device):
    """(2) RULE_STEPS steps of each of rule_optimizers() on LeNet, card
    against CPU port."""
    from paddle_tpu_torch import fluid
    feeds = lenet_feeds(LENET_B, RULE_STEPS)
    for name, (make, lr) in rule_optimizers().items():
        form, _, opt = build_lenet(fluid, make)
        blk = form[0].global_block
        inner = getattr(opt, "inner_optimizer", opt)
        clipped = [n for n in blk.vars if n.endswith("@CLIP")]
        fetch = [inner._lr_name] + (clipped or [
            n for n in blk.vars if n.endswith("@GRAD")])
        state = static_state(form[1], fluid.CPUPlace())
        g, _ = program_steps(form, state, fluid.CUDAPlace(0), feeds, fetch,
                             RULE_STEPS)
        c, _ = program_steps(form, state, fluid.CPUPlace(), feeds, fetch,
                             RULE_STEPS)
        worst = hold_steps(f"static-train {name}", g, c, state, lr)
        ops = sorted({op.type for op in blk.ops[
            next(i for i, op in enumerate(blk.ops)
                 if op.type == "backward") + 1:]})
        say("static-train", f"{name}: {RULE_STEPS} steps on the card vs the "
            "CPU port: losses " + " ".join(f"{r['loss']:.6f}" for r in g) +
            ", lr " + " ".join(f"{float(r['fetch'][inner._lr_name]):.3e}"
                               for r in g) +
            f"; {len(fetch) - 1} {'clipped ' if clipped else ''}gradients "
            f"at {worst['grad']:.3f} of STEP_TOL, {len(g[0]['after'])} "
            f"persistables within {worst['param']:.3f} of 2.5 lr, changes "
            f"at {worst['update']:.3f} of {UPDATE_RTOL:g}; ops after "
            f"the backward: {', '.join(ops)}")


def grad_gap(a, b, names=None):
    """(the 2-norm of a - b over the gradients ``names`` (every one when
    None) but the key biases, relative to b's; the loss's relative
    difference)."""
    num = den = 0.0
    for n in b["grads"] if names is None else names:
        if ".k_b_" in n:
            continue
        want = b["grads"][n].double()
        num += float(((a["grads"][n].double() - want) ** 2).sum())
        den += float((want ** 2).sum())
    return math.sqrt(num / den), abs(a["loss"] - b["loss"]) / abs(b["loss"])


def one_step(form, state, device, b):
    """One step of a form: its loss and every @GRAD on the CPU."""
    run = StaticRun(form, state, device, b)
    vals = run.step(grads=True)
    out = dict(loss=float(vals[0]),
               grads={n: v.float().cpu() for n, v in zip(run.grads,
                                                         vals[1:])})
    del run
    return out


def check_amp_step(forms, states, device):
    """(3) one step of (d) in bf16 and in fp16 on the card against the CPU
    port at B=2 (every gradient, and the last layer's) and against the
    card's fp32 (c) at B=8; then the controls the checks must reject: the
    card's fp32 (c) against the CPU port's (d), a step not in mixed
    precision (the last layer's limit); norm_cast_variant, the norms on
    bf16 rows (the program guard and the launch-dtype guard); fp16 from a
    loss scale of 1, whose backward underflows (every gradient's
    limit)."""
    import paddle_tpu_torch as pt
    cpu = torch.device("cpu")
    last = last_layer_grads(forms["d"][0])
    c2 = one_step(forms["c"], states["c"], device, STATIC_CPU_B)

    def held(what, dtype, got, want, names=None, tol=None):
        g, l = grad_gap(got, want, names)
        tol = tol if tol is not None else AMP_GRAD_REL[dtype]
        say("static-train", f"one step, {what}: gradients {g:.5f} of their "
            f"norm, loss {l:.2e} relative (tol {tol:g} and "
            f"{AMP_LOSS_RTOL:g})")
        if g > tol or l > AMP_LOSS_RTOL:
            fail(f"static-train: {what} off by {g} (gradients), {l} (loss)")

    def rejected(what, got, want, names, tol):
        g, _ = grad_gap(got, want, names)
        say("static-train", f"one step, control {what}: gradients {g:.5f} "
            f"of their norm (must exceed {tol:g})")
        if g <= tol:
            fail(f"static-train: control {what} is within the tolerance "
                 f"({g} <= {tol}): the check cannot see it")

    refs = {}
    for dtype, key in (("bfloat16", "d"), ("float16", "d16")):
        faults = amp_program_faults(forms[key][0], dtype)
        if faults:
            fail(f"static-train (d) {dtype}: the rewritten program "
                 f"{faults[:3]}")
        card = one_step(forms[key], states[key], device, STATIC_CPU_B)
        refs[dtype] = ref = one_step(forms[key], states[key], cpu,
                                     STATIC_CPU_B)
        where = f"card vs CPU port, B={STATIC_CPU_B}"
        held(f"(d) {dtype} {where}", dtype, card, ref)
        held(f"(d) {dtype} {where}, the last layer's {len(last)} "
             "gradients", dtype, card, ref, last, AMP_LAST_REL[dtype])
        rejected(f"fp32 (c) on the card vs the CPU port's (d) {dtype}, "
                 f"B={STATIC_CPU_B}, the last layer's", c2, ref, last,
                 AMP_LAST_REL[dtype])
    del card, c2

    # the norms on bf16 rows: both guards must name it
    variant, _ = norm_cast_variant(pt, "bfloat16")
    faults = amp_program_faults(variant[0], "bfloat16")
    with LaunchDtypes() as seen:
        v2 = one_step(variant, static_state(variant[1], device), device,
                      STATIC_CPU_B)
    launched = launch_dtype_faults(seen.seen, "bfloat16")
    g, _ = grad_gap(v2, refs["bfloat16"])
    g_last, _ = grad_gap(v2, refs["bfloat16"], last)
    say("static-train", f"one step, control norm_cast_variant (residual "
        f"adds white-listed, the norms' casts dropped) card vs the CPU "
        f"port's (d) bfloat16, B={STATIC_CPU_B}: gradients {g:.5f} of "
        f"their norm, the last layer's {g_last:.5f}; program guard: "
        f"{len(faults)} faults ({faults[:1]}); launch guard: {launched}")
    if not faults or not launched:
        fail("static-train: a guard passes norm_cast_variant: program "
             f"{faults}, launches {launched}")
    del v2

    wrong, _ = amp_form(pt, "float16", init_loss_scaling=1.0)
    w_state = static_state(wrong[1], device)
    rejected(f"fp16 from a loss scale of 1 vs the CPU port's (d) float16, "
             f"B={STATIC_CPU_B}", one_step(wrong, w_state, device,
                                           STATIC_CPU_B),
             refs["float16"], None, max(AMP_GRAD_REL.values()))
    c8 = one_step(forms["c"], states["c"], device, STATIC_B)
    for dtype, key in (("bfloat16", "d"), ("float16", "d16")):
        held(f"(d) {dtype} vs (c) on the card, B={STATIC_B}", dtype,
             one_step(forms[key], states[key], device, STATIC_B), c8)
    rejected(f"fp16 from a loss scale of 1 vs (c) on the card, "
             f"B={STATIC_B}", one_step(wrong, w_state, device, STATIC_B),
             c8, None, max(AMP_GRAD_REL.values()))
    del c8, refs
    torch.cuda.empty_cache()


def launch_dtype_faults(seen, dtype):
    """What LaunchDtypes saw that breaks form (d)'s plan: the flash
    kernels on other than ``dtype``, the layer norms on other than
    float32 rows."""
    want = dict(flash_attention_fwd={dtype}, flash_attention_bwd={dtype},
                layer_norm_fwd={"float32"}, layer_norm_bwd={"float32"})
    return [f"{k} on {sorted(seen[k])}" for k, v in want.items()
            if seen[k] != v]


def amp_run(form, state, device, b, steps, extra=()):
    """``steps`` steps of a form at batch ``b``, counts set to 0 just before
    and read just after: losses, counts, path logs, launch dtypes, the
    parameters after, and ``extra`` persistables (scale, counters) after
    each step."""
    run = StaticRun(form, state, device, b)
    reset_counts()
    reset_static_logs()
    losses, seq = [], []
    with LaunchDtypes() as seen:
        for _ in range(steps):
            losses.append(run.step()[0])
            seq.append([run.scope.find_var(n).item() for n in extra])
        torch.cuda.synchronize()
    counts, paths = read_counts(), static_paths()
    return dict(losses=[float(x) for x in losses], counts=counts,
                paths=paths, dtypes=seen.seen, params=run.params(),
                seq=seq)


def amp_expect(n_layers, recompute=False):
    """Launches a step of form (d): each layer's flash forward, dQ and
    dK/dV and its two norms' forward and backward; recompute runs each
    layer's forward again in the backward (its flash forward and its two
    norms' forward)."""
    again = 2 if recompute else 1
    return dict(layer_norm_fwd=2 * n_layers * again,
                layer_norm_bwd=2 * n_layers,
                flash_attention_fwd=n_layers * again,
                flash_attention_bwd_dq=n_layers,
                flash_attention_bwd_dkv=n_layers,
                flash_attention_fwd_copies=0)


def check_amp_run(run, label, dtype, steps, recompute=False):
    n_layers = STATIC_CFG["layers_n"]
    per = amp_expect(n_layers, recompute)
    want = {k: v * steps for k, v in per.items()}
    attn, ln = run["paths"]
    if run["counts"] != want:
        fail(f"{label}: launches {run['counts']}, want {want}")
    if attn != ["flash"] * (per["flash_attention_fwd"] * steps) or \
            ln != ["kernel"] * (per["layer_norm_fwd"] * steps):
        fail(f"{label}: path logs {sorted(set(attn))} x {len(attn)}, "
             f"{sorted(set(ln))} x {len(ln)}")
    faults = launch_dtype_faults(run["dtypes"], dtype)
    if faults:
        fail(f"{label}: {faults}; want flash on {dtype}, layer norms on "
             "float32 rows")
    losses = run["losses"]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"{label}: losses not finite or not falling: {losses}")
    return per


def check_overflow(device, state_of):
    """(4) fp16 from a loss scale at which the backward overflows, at
    B=OVERFLOW_B on the card and on the CPU port: each overflow step's
    gradients are zero and its update ops still run (the beta powers
    advance); the scale and the good/bad counters follow
    update_loss_scaling's rule and equal the CPU port's sequence."""
    import paddle_tpu_torch as pt
    cpu = torch.device("cpu")
    for exp in OVERFLOW_EXPONENTS:
        form, names = amp_form(pt, "float16", init_loss_scaling=2.0 ** exp)
        main = form[0]
        found = next(n for n in main.global_block.vars
                     if n.startswith("found_inf"))
        grad = next(n for n in main.global_block.vars
                    if n.endswith("@GRAD"))
        b1p = next(n for n in main.global_block.vars
                   if n.endswith("@Adam@beta1_pow"))
        state = state_of(form)
        feeds = [static_feed(OVERFLOW_B)]
        fetch = [found, grad]
        keep = (names["scale"], names["good"], names["bad"], b1p)
        out = {}
        for key, where in (("card", device), ("cpu", cpu)):
            out[key], _ = program_steps(form, state, where, feeds, fetch,
                                        OVERFLOW_STEPS, keep)
        g = out["card"]
        flags = [bool(r["fetch"][found]) for r in g]
        if any(flags):
            break
    else:
        fail(f"fp16 overflow: no step overflowed from 2^"
             f"{OVERFLOW_EXPONENTS[-1]}")
    seq = {w: [(float(r["after"][names["scale"]]),
                int(r["after"][names["good"]]),
                int(r["after"][names["bad"]])) for r in runs]
           for w, runs in out.items()}
    rule = scaling_after(2.0 ** exp, flags)
    if not seq["card"] == seq["cpu"] == rule:
        fail(f"fp16 overflow: scale/good/bad {seq['card']} on the card, "
             f"{seq['cpu']} on the CPU port, {rule} by the rule")
    for i, r in enumerate(g):
        if flags[i] and float(r["fetch"][grad].abs().max()) != 0.0:
            fail(f"fp16 overflow step {i + 1}: {grad} not zeroed")
        if abs(float(r["after"][b1p]) - 0.9 ** (i + 2)) > 1e-6:
            fail(f"fp16 overflow step {i + 1}: {b1p} "
                 f"{float(r['after'][b1p])}, want 0.9^{i + 2}: the update "
                 "did not run")
    say("static-train", f"fp16 overflow run from 2^{exp} at "
        f"B={OVERFLOW_B}: found_inf {flags}; scale/good/bad after each "
        f"step {seq['card']} on the card, on the CPU port and by the "
        "rule; each overflow step's gradients zero and Adam's "
        "beta powers advanced (the update ops ran)")


def check_static_recompute(forms, states, device):
    """(5) (d) with recompute segments against (d) without, one step each
    at B=8 on the card: loss and every gradient, the launches, and the
    peak memory of each."""
    out = {}
    for key in ("d", "d_remat"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = StaticRun(forms[key], states["d"], device, STATIC_B)
        base = torch.cuda.memory_allocated()
        reset_counts()
        vals = run.step(grads=True)
        torch.cuda.synchronize()
        out[key] = dict(loss=vals[0].float().cpu(), counts=read_counts(),
                        grads={n: v.cpu() for n, v in zip(run.grads,
                                                          vals[1:])},
                        peak=torch.cuda.max_memory_allocated() - base,
                        recomputed=dict(run.exe.recomputed))
        del run, vals
    a, b = out["d"], out["d_remat"]
    n_layers = STATIC_CFG["layers_n"]
    if b["counts"] != amp_expect(n_layers, recompute=True) or \
            a["counts"] != amp_expect(n_layers):
        fail(f"recompute: launches {b['counts']} (without: {a['counts']})")
    same = torch.equal(a["loss"], b["loss"]) and all(
        torch.equal(a["grads"][n], b["grads"][n]) for n in a["grads"])
    worst = max(float((a["grads"][n].float() - b["grads"][n].float())
                      .abs().max()) for n in a["grads"])
    if not same:
        fail(f"recompute: loss {float(b['loss'])} / {float(a['loss'])}, "
             f"gradients off by up to {worst}: not bitwise")
    say("static-train", f"(d) bf16 with recompute segments (checkpoints at "
        f"each layer's output) vs without, B={STATIC_B}: loss and all "
        f"{len(a['grads'])} gradients bitwise equal; launches a step "
        + ", ".join(f"{k} {v}" for k, v in b["counts"].items()) +
        f" (without: flash fwd {a['counts']['flash_attention_fwd']}, "
        f"layer norm fwd {a['counts']['layer_norm_fwd']}); ops re-run in the "
        f"backward {sum(b['recomputed'].values())}; step memory peak "
        f"{b['peak'] / 2**20:.1f} MiB with, {a['peak'] / 2**20:.1f} MiB "
        "without (above the state)")
    return {k: v["peak"] for k, v in out.items()}


def time_flash_static(device, card):
    """The bf16 and fp16 flash forward, dQ and dK/dV at form (d)'s call,
    [8, 12, 128, 64] with no bias: kernel, bound, plain version, and SDPA's
    forward and backward in the same dtype."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as FA
    b, h, s, d = STATIC_B, STATIC_CFG["heads"], STATIC_CFG["S"], \
        STATIC_CFG["H"] // STATIC_CFG["heads"]
    scale = 1.0 / math.sqrt(d)
    records = {}
    for dtype in (torch.bfloat16, torch.float16):
        sets = copies(lambda i: attn_inputs(b, h, s, s, d, dtype, device,
                                            700 + i),
                      3 * b * h * s * d * 2)
        ms = device_ms([lambda x=x: FA.flash_attention_fwd(*x, None)
                        for x in sets])
        plain_ms = device_ms([lambda x=x: FA.attention_reference(
            *x, None) for x in sets])
        lib_ms = device_ms([lambda x=x: torch.nn.functional
                            .scaled_dot_product_attention(*x, scale=scale)
                            for x in sets])
        nbytes, flops = attn_work(sets[0][0], sets[0][1], None, False)
        bms, by = bound_ms(nbytes, flops, dtype)
        name = str(dtype)[6:]
        records[(name, "fwd")] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=bms,
                                      bound_by=by)
        say("times", f"static {name} flash fwd [{b},{h},{s},{d}]: kernel "
            f"{ms:.4f} ms, bound {bms:.4f} ms ({by}), plain {plain_ms:.4f} "
            f"ms, SDPA {lib_ms:.4f} ms  [{card}]")
        q, k, v, do = attn_grad_inputs(b, h, s, s, d, dtype, device,
                                       "contiguous", 710)
        o, lse = FA._launch_fwd(q, k, v, None, False, scale, None, None, 1.0)
        args, grads, held = FA.bwd_args(do, q, k, v, o, lse, None, False,
                                        scale, None, None, 1.0)
        fns = {w: FA.bwd_kernel(w) for w in ("dq", "dkv")}
        fns["dq"](*args, _build.stream_ptr(device))
        ms = {w: device_ms([lambda f=f: f(*args, _build.stream_ptr(device))])
              for w, f in fns.items()}
        plain_ms = device_ms([lambda: FA.attention_backward_reference(
            do, q, k, v, o, lse, None, False, scale, None, 1.0)], reps=3)
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, scale=scale)
        lib_ms = profiled_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True))
        for w in ("dq", "dkv"):
            nbytes, flops = bwd_work(q, k, None, w)
            bms, by = bound_ms(nbytes, flops, dtype)
            records[(name, w)] = dict(ms=ms[w], plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=bms,
                                      bound_by=by)
            say("times", f"static {name} flash_bwd_{w} [{b},{h},{s},{d}]: "
                f"kernel {ms[w]:.4f} ms, bound {bms:.4f} ms ({by}), plain "
                f"backward {plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms"
                f"  [{card}]")
        del held, grads, out, ql, kl, vl, sets
    torch.cuda.empty_cache()
    return records


def run_static_train(device, card):
    """Phase 11. Returns the main path's launch counts: STATIC_STEPS steps
    of form (d) in bf16."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.passes import apply_pass
    n_layers = STATIC_CFG["layers_n"]
    t0 = time.perf_counter()
    check_lenet(device, card)
    check_rules(device)
    say("static-train", f"LeNet and the update rules in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    c_main, c_startup, c_loss = build_bert_shaped(pt, **STATIC_CFG,
                                                  norm_axis=2)
    c_startup.random_seed = STATIC_SEED
    forms = {"c": (apply_pass(c_main, "multihead_matmul_fuse"), c_startup,
                   c_loss.name)}
    names = {}
    forms["d"], names["d"] = amp_form(pt, "bfloat16")
    forms["d16"], names["d16"] = amp_form(pt, "float16")
    forms["d_remat"], _ = amp_form(pt, "bfloat16", recompute=True)
    states = {k: static_state(forms[k][1], device) for k in ("c", "d", "d16")}
    shared = [n for n in states["c"] if n in states["d"] and "@" not in n]
    if any(not np.array_equal(states["c"][n], states["d"][n])
           for n in shared):
        fail("static-train: forms (c) and (d) from one seed drew different "
             "weights")
    segs = next(op for op in forms["d_remat"][0].global_block.ops
                if op.type == "backward").attr("remat_segments")
    say("static-train", f"form (d) {STATIC_CFG}: ops "
        + ", ".join(f"({k}) {len(v[0].global_block.ops)}"
                    for k, v in forms.items()) +
        f"; {len(segs)} recompute segments; built and started from seed "
        f"{STATIC_SEED} in {time.perf_counter() - t0:.1f} s; {len(shared)} "
        "weights equal across (c) and (d)")

    t0 = time.perf_counter()
    check_amp_step(forms, states, device)
    say("static-train", f"one-step checks in {time.perf_counter() - t0:.1f} "
        "s")

    # the main path: ten bf16 steps of (d), counts set to 0 just before
    t0 = time.perf_counter()
    run = amp_run(forms["d"], states["d"], device, STATIC_B, STATIC_STEPS)
    per = check_amp_run(run, "static-train (d) bf16 main path", "bfloat16",
                        STATIC_STEPS)
    again = amp_run(forms["d"], states["d"], device, STATIC_B, STATIC_STEPS)
    diff = max(float((run["params"][n] - again["params"][n]).abs().max())
               for n in run["params"])
    if again["losses"] != run["losses"] or diff != 0.0:
        fail(f"static-train (d) rerun: losses {again['losses']} against "
             f"{run['losses']}, parameters off by up to {diff}")
    say("static-train", f"(d) bf16 main path, {STATIC_STEPS} steps at "
        f"B={STATIC_B}: losses " + " ".join(f"{v:.8f}" for v in
                                            run["losses"]) +
        "; launches a step " + ", ".join(f"{k} {v}" for k, v in per.items())
        + f"; flash on {sorted(run['dtypes']['flash_attention_fwd'])}, "
        f"layer norms on {sorted(run['dtypes']['layer_norm_fwd'])}; path "
        f"logs {len(run['paths'][0])} x 'flash', {len(run['paths'][1])} x "
        "'kernel'; a rerun from the same state is bitwise equal")
    counts = run["counts"]
    del run, again
    torch.cuda.empty_cache()

    n16 = names["d16"]
    run = amp_run(forms["d16"], states["d16"], device, STATIC_B,
                  STATIC_STEPS, (n16["scale"], n16["good"], n16["bad"]))
    check_amp_run(run, "static-train (d) fp16", "float16", STATIC_STEPS)
    rule = scaling_after(2.0 ** 15, [False] * STATIC_STEPS)
    if [tuple(x) for x in run["seq"]] != rule:
        fail(f"static-train (d) fp16: scale/good/bad {run['seq']}, by the "
             f"rule with no overflow {rule}")
    say("static-train", f"(d) fp16 with dynamic loss scaling from 2^15, "
        f"{STATIC_STEPS} steps at B={STATIC_B}: losses "
        + " ".join(f"{v:.8f}" for v in run["losses"]) + "; scale/good/bad "
        f"after each step {run['seq']} (the rule's, no step overflowing); "
        "flash on "
        f"{sorted(run['dtypes']['flash_attention_fwd'])}, layer norms on "
        f"{sorted(run['dtypes']['layer_norm_fwd'])}")
    del run
    torch.cuda.empty_cache()
    say("static-train", f"bf16 and fp16 runs in {time.perf_counter() - t0:.1f}"
        " s")
    t0 = time.perf_counter()
    check_overflow(device, lambda form: static_state(form[1], device))
    say("static-train", f"overflow run in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    peaks = check_static_recompute(forms, states, device)
    timed = {"(c) fp32": StaticRun(forms["c"], states["c"], device,
                                   STATIC_B),
             "(d) bf16": StaticRun(forms["d"], states["d"], device,
                                   STATIC_B),
             "(d) fp16": StaticRun(forms["d16"], states["d16"], device,
                                   STATIC_B),
             "(d) bf16 recompute": StaticRun(forms["d_remat"], states["d"],
                                             device, STATIC_B)}
    time_runs(timed, card, "static-train")
    del timed
    torch.cuda.empty_cache()
    flash = time_flash_static(device, card)
    say("static-train", f"recompute and times in "
        f"{time.perf_counter() - t0:.1f} s")
    return counts, flash, peaks


# -- phase 12: sparse embeddings, LoD feeds, lazy fetches, control flow

# the "medium" LSTM language model of Zaremba et al. 2014 (arXiv:1409.2329),
# the configuration of Paddle's static PTB model
LM_CFG = dict(vocab=10000, hidden=650, layers_n=2, steps=35, batch=20,
              dropout=0.5, init=0.05, clip=5.0, lr=1.0)
LM_SEED = 1409
LM_STEPS = 10


def build_lstm_lm(pt, vocab=10000, hidden=650, layers_n=2, steps=35,
                  batch=20, dropout=0.5, init=0.05, clip=5.0, lr=1.0):
    """A layers_n-layer LSTM language model through ``layers.StaticRNN``
    with package ``pt``'s public ``layers``: ids [steps, batch, 1], an
    embedding [vocab, hidden], each cell an fc of [x ; h] to 4 hidden
    ``split`` into the gates i, f, g, o (sigmoid, sigmoid, tanh, sigmoid),
    c = f c + i g, h = o tanh(c); dropout (upscale in train) on the
    embedding and on each layer's output; a softmax projection to vocab,
    the mean of ``softmax_with_cross_entropy`` over the steps x batch
    labels, ``SGD(lr)`` under ``GradientClipByGlobalNorm(clip)``; every
    weight U(-init, init). Returns (main, startup, loss)."""
    L = pt.layers
    uni = L.Uniform(-init, init)

    def attr(name):
        return pt.ParamAttr(name=name, initializer=uni)

    def drop(v):
        return L.dropout(v, dropout,
                         dropout_implementation="upscale_in_train") \
            if dropout else v

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [steps, batch, 1], dtype="int64",
                   append_batch_size=False)
        y = L.data("y", [steps * batch, 1], dtype="int64",
                   append_batch_size=False)
        emb = drop(L.embedding(x, [vocab, hidden],
                               param_attr=attr("embedding")))
        zeros = [(L.fill_constant([batch, hidden], "float32", 0.0),
                  L.fill_constant([batch, hidden], "float32", 0.0))
                 for _ in range(layers_n)]
        rnn = L.StaticRNN()
        with rnn.step():
            inp = rnn.step_input(emb)
            for i in range(layers_n):
                h_prev = rnn.memory(init=zeros[i][0])
                c_prev = rnn.memory(init=zeros[i][1])
                gates = L.fc(L.concat([inp, h_prev], axis=1), 4 * hidden,
                             param_attr=attr(f"lstm{i}.w"),
                             bias_attr=attr(f"lstm{i}.b"))
                g_i, g_f, g_g, g_o = L.split(gates, 4, axis=1)
                c = L.elementwise_add(
                    L.elementwise_mul(L.sigmoid(g_f), c_prev),
                    L.elementwise_mul(L.sigmoid(g_i), L.tanh(g_g)))
                h = L.elementwise_mul(L.sigmoid(g_o), L.tanh(c))
                rnn.update_memory(h_prev, h)
                rnn.update_memory(c_prev, c)
                inp = drop(h)
            rnn.step_output(inp)
        out = L.reshape(rnn(), [steps * batch, hidden])
        logits = L.fc(out, vocab, param_attr=attr("softmax.w"),
                      bias_attr=attr("softmax.b"))
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        pt.optimizer.SGD(lr, grad_clip=pt.optimizer.GradientClipByGlobalNorm(
            clip)).minimize(loss, startup_program=startup, program=main)
    return main, startup, loss


def lm_feeds(n, vocab=10000, steps=35, batch=20, seed=LM_SEED):
    """n consecutive windows of a token stream made from ``seed``: Zipf
    (a=1.2) ids folded into the vocabulary, so that there is a unigram
    law to learn; x the window, y the next token."""
    rng = np.random.default_rng(seed)
    total = n * steps * batch + batch
    stream = ((rng.zipf(1.2, total) - 1) % vocab).astype(np.int64)
    stream = stream.reshape(batch, -1)           # batch rows of text
    feeds = []
    for k in range(n):
        win = stream[:, k * steps:(k + 1) * steps + 1]
        feeds.append({"x": win[:, :-1].T.reshape(steps, batch, 1).copy(),
                      "y": win[:, 1:].T.reshape(steps * batch, 1).copy()})
    return feeds


# the programs of tests/test_control_flow.py, each built with package
# ``pt``'s public layers: (main, startup, [fetch vars])

def cf_while_sum(pt):
    """while i < 10: s += i; i += 1."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 10)
        s = L.fill_constant([1], "float32", 0.0)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            L.assign(L.elementwise_add(s, L.cast(i, "float32")), s)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), cond_v)
        out = L.assign(s)
    return main, startup, [out, i]


def cf_while_feed(pt):
    """x <- x / 2 while max(x) > 1, x fed."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [4])
        limit = L.fill_constant([1], "float32", 1.0)
        cond_v = L.greater_than(L.reshape(L.reduce_max(x), [1]), limit)
        w = L.While(cond_v)
        with w.block():
            L.assign(L.scale(x, 0.5), x)
            L.assign(L.greater_than(L.reshape(L.reduce_max(x), [1]),
                                    limit), cond_v)
        out = L.assign(x)
    return main, startup, [out]


def cf_cond(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [2])
        flag = L.data("flag", [1], dtype="bool")
        out = L.cond(flag, lambda: L.scale(x, 2.0), lambda: L.scale(x, -1.0))
    return main, startup, [out]


def cf_cond_multi(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [2])
        flag = L.data("flag", [1], dtype="bool")
        outs = L.cond(flag, lambda: (L.scale(x, 1.0), L.scale(x, 2.0)),
                      lambda: (L.scale(x, 3.0), L.scale(x, 4.0)))
    return main, startup, list(outs)


def cf_cond_grad(pt):
    """d mean(cond(flag, 2x, 5x)) / dx through the branch taken."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [2])
        x.stop_gradient = False
        flag = L.data("flag", [1], dtype="bool")
        y = L.cond(flag, lambda: L.scale(x, 2.0), lambda: L.scale(x, 5.0))
        grads = pt.gradients([L.mean(y)], [x])
    return main, startup, grads


def cf_arrays(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [3])
        i0 = L.fill_constant([1], "int64", 0)
        i1 = L.fill_constant([1], "int64", 1)
        arr = L.array_write(L.scale(x, 1.0), i0)
        L.array_write(L.scale(x, 10.0), i1, array=arr)
        outs = [L.array_length(arr), L.array_read(arr, i0),
                L.array_read(arr, i1)]
    return main, startup, outs


def cf_print_assert(pt, bound=100.0):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [2])
        y = L.Print(x, message="cf_print_assert:")
        L.Assert(L.less_than(L.reduce_sum(y, keep_dim=True),
                             L.fill_constant([1], "float32", bound)))
        out = L.scale(y, 2.0)
    return main, startup, [out]


def cf_while_loop(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        i = L.fill_constant([1], value=0, dtype="int64")
        s = L.fill_constant([1], value=0, dtype="int64")
        i, s = L.while_loop(
            lambda i, s: L.less_than(i, L.fill_constant([1], value=5,
                                                        dtype="int64")),
            lambda i, s: [L.elementwise_add(i, L.fill_constant(
                [1], value=1, dtype="int64")), L.elementwise_add(s, i)],
            [i, s])
    return main, startup, [i, s]


def cf_case_switch(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", [1])
        zero = L.fill_constant([1], value=0.0, dtype="float32")
        out = L.case([(L.less_than(x, zero),
                       lambda: L.elementwise_mul(x, x))],
                     default=lambda: L.elementwise_add(x, x))
        idx = L.data("idx", [1], dtype="int64")
        sw = L.switch_case(idx, {0: lambda: L.elementwise_add(x, x),
                                 1: lambda: L.elementwise_mul(x, x)},
                           default=lambda: L.elementwise_sub(x, x))
    return main, startup, [out, sw]


def cf_switch(pt):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        step = L.data("step", [1])
        lr = L.fill_constant([1], value=0.0, dtype="float32")
        thresh = L.fill_constant([1], value=10.0, dtype="float32")
        with L.Switch() as switch:
            with switch.case(L.less_than(step, thresh)):
                L.assign(L.fill_constant([1], value=0.1, dtype="float32"),
                         lr)
            with switch.default():
                L.assign(L.fill_constant([1], value=0.01, dtype="float32"),
                         lr)
    return main, startup, [lr]


def _f32(*rows):
    return np.asarray(rows, np.float32)


# name -> (builder, [(feed, the expected fetches)]) at the JAX tests' sizes
CF_CASES = {
    "while to n": (cf_while_sum, [({}, [_f32(45.0), np.array([10])])]),
    "while with a feed": (cf_while_feed, [(
        {"x": _f32([8.0, 2.0, 0.5, 7.9])}, [_f32([1.0, 0.25, 0.0625,
                                                  0.9875])])]),
    "cond": (cf_cond, [
        ({"x": _f32([1.0, 3.0]), "flag": np.array([True])},
         [_f32([2.0, 6.0])]),
        ({"x": _f32([1.0, 3.0]), "flag": np.array([False])},
         [_f32([-1.0, -3.0])])]),
    "cond multi-output": (cf_cond_multi, [
        ({"x": _f32([1.0, 1.0]), "flag": np.array([False])},
         [_f32([3.0, 3.0]), _f32([4.0, 4.0])])]),
    "cond gradient": (cf_cond_grad, [
        ({"x": np.ones((2, 2), np.float32), "flag": np.array([True])},
         [np.full((2, 2), 0.5, np.float32)]),
        ({"x": np.ones((2, 2), np.float32), "flag": np.array([False])},
         [np.full((2, 2), 1.25, np.float32)])]),
    "arrays": (cf_arrays, [({"x": _f32([1.0, 2.0, 3.0])},
                            [np.array([2]), _f32([1.0, 2.0, 3.0]),
                             _f32([10.0, 20.0, 30.0])])]),
    "Print/Assert": (cf_print_assert, [({"x": _f32([1.0, 1.0])},
                                        [_f32([2.0, 2.0])])]),
    "while_loop": (cf_while_loop, [({}, [np.array([5]), np.array([10])])]),
    "case/switch_case": (cf_case_switch, [
        ({"x": _f32([-3.0]), "idx": np.array([1])},
         [_f32([9.0]), _f32([9.0])]),
        ({"x": _f32([2.0]), "idx": np.array([5])},
         [_f32([4.0]), _f32([0.0])])]),
    "Switch": (cf_switch, [({"step": _f32([3.0])}, [np.float32([0.1])]),
                           ({"step": _f32([30.0])}, [np.float32([0.01])])]),
}


def check_control_flow(device):
    """(iii) each program of CF_CASES on the card and on the CPU port:
    every fetch equal on the two (the branches and loops run the same
    ops; the fp32 ones are exact scalings) and to the expected values;
    the host reads a run. Returns the total host reads."""
    import paddle_tpu_torch as pt
    total = 0
    for name, (build, runs) in CF_CASES.items():
        main, startup, fetch = build(pt)
        names = [v.name for v in fetch]
        reads = []
        for feed, want in runs:
            outs = {}
            for label, where in (("card", device), ("cpu", "cpu")):
                exe, scope = pt.Executor(where), pt.Scope()
                exe.run(startup, scope=scope)
                outs[label] = exe.run(main, feed=feed, fetch_list=names,
                                      scope=scope)
                if label == "card":
                    reads.append(exe.host_syncs)
            for n, g, c, w in zip(names, outs["card"], outs["cpu"], want):
                if not np.array_equal(g, c):
                    fail(f"control flow {name}: {n} {g} on the card, {c} on "
                         "the CPU port")
                if not np.allclose(g, np.asarray(w).reshape(g.shape),
                                   rtol=1e-6, atol=0):
                    fail(f"control flow {name}: {n} {g}, expected {w}")
        total += sum(reads)
        say("sparse-cf", f"control flow {name}: {len(runs)} run(s), card "
            f"= CPU port = expected; host reads a run {reads}")
    return total


# -- (i) Wide&Deep at the JAX model's widths
WD_B = 1024
WD_STEPS = 20
WD_SEED = 4242
WD_LR = 1e-3
WD_RULE_STEPS = 3
# one fp32 step, card (TF32 off) against the CPU port: the MLP's 3 GFLOP in
# other orders; the loss within 1e-5 relative, each gradient at STEP_TOL
# (1e-4 of its largest element + 1e-4 relative, a floor of 1e-5 of the
# largest gradient), the table's merged rows exactly and its values at
# STEP_TOL, every parameter after an Adam step within 2.5 lr (Adam moves a
# weight ~lr whatever its gradient, so a near-0 gradient of another sign
# lands 2 lr away). The other rules: SGD/Momentum/Adagrad/AdamW/Lamb each
# at 2.5 lr of its own rate.
WD_RULES = {"sgd": (lambda T, ps: T.SGD(0.1, parameters=ps), 0.1),
            "momentum": (lambda T, ps: T.Momentum(0.1, momentum=0.9,
                                                  parameters=ps), 0.1),
            "adagrad": (lambda T, ps: T.Adagrad(0.01, parameters=ps), 0.01),
            "adamw": (lambda T, ps: T.AdamW(1e-3, weight_decay=0.01,
                                            parameters=ps), 1e-3),
            "lamb": (lambda T, ps: T.Lamb(1e-3, parameters=ps), 1e-3)}
WD_OVERFLOW_SCALE = 2.0 ** 32
WD_SCALE = 2.0 ** 10
# fp16 auto_cast, card against the CPU port: the table's gradient rows come
# back through the MLP's four fp16 GEMMs forward and four backward, each
# rounding its output once on each side in its own order (fp16 unit
# roundoff 2^-11), so the unscaled values agree to 8 units in norm
WD_FP16_REL = 8 * 2.0 ** -11


def wd_batches(n, b=WD_B, slots=26, vocab=100000, dense_dim=13,
               seed=WD_SEED):
    """n batches: ids Zipf (a=1.2) folded into the table's rows, dense
    features N(0, 1), labels 1 where a fixed random linear map of the
    dense features is positive. numpy arrays."""
    rng = np.random.default_rng(seed)
    rule = rng.standard_normal(dense_dim).astype(np.float32)
    out = []
    for _ in range(n):
        ids = ((rng.zipf(1.2, (b, slots)) - 1) % vocab).astype(np.int64)
        dense = rng.standard_normal((b, dense_dim)).astype(np.float32)
        label = (dense @ rule > 0).astype(np.float32)[:, None]
        out.append((ids, dense, label))
    return out


def wd_model(state, device, cfg):
    """WideDeep(**cfg) on ``device`` with a sparse table, its weights
    ``state`` (numpy by name) through load_reference_state."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.jit import load_reference_state
    from paddle_tpu_torch.models.wide_deep import WideDeep
    table = nn.Embedding(cfg.get("sparse_feature_number", 100000),
                         cfg.get("sparse_feature_dim", 16), sparse=True,
                         device=device)
    model = WideDeep(**cfg, distributed_embedding=table, device=device)
    load_reference_state(model, state)
    return model


def wd_state(cfg, seed=WD_SEED):
    """The weights of WideDeep(**cfg) as drawn under the port's seed, as
    numpy arrays by name."""
    from paddle_tpu_torch.jit import state_of
    from paddle_tpu_torch.layers.helper import seed as port_seed
    from paddle_tpu_torch.models.wide_deep import WideDeep
    port_seed(seed)
    return {n: t.detach().numpy().copy()
            for n, t in state_of(WideDeep(**cfg, device="cpu")).items()}


def wd_on(batch, device):
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def wd_step(model, opt, batch, scaler=None, amp_dtype=None, keep=False):
    """One step; the loss (a 0-d tensor) and, with ``keep``, the gradients
    before the update: dense ones cloned, the table's merged
    SelectedRows."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    ids, dense, label = batch
    with amp.auto_cast(enable=amp_dtype is not None,
                       dtype=amp_dtype or "bfloat16"):
        logit = model(ids, dense)
    loss = model.loss(logit.float(), label)
    (scaler.scale(loss) if scaler is not None else loss).backward()
    grads = None
    if keep:
        grads = {}
        for n, p in model.named_parameters():
            g = p.grad
            grads[n] = SelectedRows.from_grad(g).merged() \
                if g.layout == torch.sparse_coo else g.detach().clone()
    if scaler is not None:
        scaler.minimize(opt)
    else:
        opt.step()
    opt.clear_grad()
    return loss.detach(), grads


def hold_tensor(label, got, want, atol, rtol=0.0):
    e, ok = max_err(got.detach().cpu(), want.detach().cpu(), atol, rtol)
    if not ok:
        fail(f"{label}: off by {e} (atol {atol:g}, rtol {rtol:g})")
    return e


def hold_grads(label, got, want):
    """Each gradient at STEP_TOL; a SelectedRows' rows exactly. Returns
    the worst share of the tolerance."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    def vals(g):
        return g.values if isinstance(g, SelectedRows) else g
    top = max(float(vals(g).abs().max()) for g in want.values())
    worst = 0.0
    for n, w in want.items():
        g = got[n]
        if isinstance(w, SelectedRows):
            if not torch.equal(g.rows.cpu(), w.rows.cpu()):
                fail(f"{label}: {n}'s merged rows differ")
        w, g = vals(w), vals(g)
        atol = STEP_TOL["grad_rel"] * float(w.abs().max()) + \
            STEP_TOL["grad_floor"] * top
        e = hold_tensor(f"{label} {n} gradient", g, w, atol,
                        STEP_TOL["grad_rel"])
        worst = max(worst, e / max(atol, 1e-30))
    return worst


def hold_params(label, got_model, want_model, lr):
    want = dict(want_model.named_parameters())
    return max(hold_tensor(f"{label} {n}", p, want[n], 2.5 * lr) /
               (2.5 * lr) for n, p in got_model.named_parameters())


def check_wd_vs_cpu(device, state, batches, cfg):
    """(i) one Adam step and WD_RULE_STEPS of each WD_RULES optimizer, card
    against the CPU port; the fp16 GradScaler run with an overflow step."""
    from paddle_tpu_torch import optimizer as T
    where = {"card": device, "cpu": torch.device("cpu")}
    models = {k: wd_model(state, w, cfg) for k, w in where.items()}
    opts = {k: T.Adam(WD_LR, parameters=list(m.parameters()))
            for k, m in models.items()}
    out = {k: wd_step(models[k], opts[k], wd_on(batches[0], w), keep=True)
           for k, w in where.items()}
    (lg, gg), (lc, gc) = out["card"], out["cpu"]
    if abs(float(lg) - float(lc)) > STEP_TOL["loss_rtol"] * abs(float(lc)):
        fail(f"Wide&Deep step: loss {float(lg)} on the card, {float(lc)} on "
             "the CPU port")
    gw = hold_grads("Wide&Deep step", gg, gc)
    pw = hold_params("Wide&Deep step", models["card"], models["cpu"], WD_LR)
    table = gc["embedding.weight"]
    say("sparse-cf", f"Wide&Deep one Adam({WD_LR:g}) step at "
        f"B={len(batches[0][0])}, card "
        f"vs CPU port: loss {float(lg):.7f} / {float(lc):.7f}; gradients at "
        f"{gw:.3f} of STEP_TOL, the table's merged SelectedRows of "
        f"{int(table.valid().sum())} rows (of {table.rows.shape[0]} ids) "
        f"equal in rows; parameters after within {pw:.3f} of 2.5 lr")
    for name, (make, lr) in WD_RULES.items():
        models = {k: wd_model(state, w, cfg) for k, w in where.items()}
        opts = {k: make(T, list(m.parameters()))
                for k, m in models.items()}
        losses = {k: [] for k in models}
        for i in range(WD_RULE_STEPS):
            for k, w in where.items():
                losses[k].append(float(wd_step(
                    models[k], opts[k], wd_on(batches[i], w))[0]))
            worst = hold_params(f"Wide&Deep {name} step {i + 1}",
                                models["card"], models["cpu"], lr)
        say("sparse-cf", f"Wide&Deep {name}: {WD_RULE_STEPS} steps card vs "
            "CPU port, losses " + " ".join(f"{v:.6f}" for v in
                                           losses["card"]) +
            f"; parameters after each within {worst:.3f} of 2.5 lr")
    check_wd_scaler(device, state, batches, cfg)


def check_wd_scaler(device, state, batches, cfg):
    """fp16 auto_cast with GradScaler: a step from WD_OVERFLOW_SCALE whose
    fp16 backward overflows is skipped (every parameter and accumulator
    bitwise unchanged, the scale halved by decr_every_n_nan_or_inf=1),
    then a step from WD_SCALE unscales the sparse values (on each side
    exactly: the scaled values over 2^10) and applies them: card against
    the CPU port at WD_FP16_REL, with the values left scaled shown to fail
    it."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as T
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    after = {}
    for side, w in (("card", device), ("cpu", torch.device("cpu"))):
        model = wd_model(state, w, cfg)
        opt = T.Adam(WD_LR, parameters=list(model.parameters()))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        scaler = GradScaler(init_loss_scaling=WD_OVERFLOW_SCALE,
                            decr_every_n_nan_or_inf=1)
        wd_step(model, opt, wd_on(batches[0], w), scaler, "float16")
        if not scaler._found_inf_last or \
                scaler.get_scale() != WD_OVERFLOW_SCALE / 2:
            fail(f"Wide&Deep fp16 on {w}: a step from 2^32 did not "
                 f"overflow (scale {scaler.get_scale()})")
        if any(not torch.equal(p.detach(), before[n])
               for n, p in model.named_parameters()) or opt._accumulators:
            fail(f"Wide&Deep fp16 on {w}: the skipped step changed the "
                 "parameters or made accumulators")
        scaler = GradScaler(init_loss_scaling=WD_SCALE)
        ids, dense, label = wd_on(batches[1], w)
        with amp.auto_cast(dtype="float16"):
            logit = model(ids, dense)
        scaler.scale(model.loss(logit.float(), label)).backward()
        scaled = model.embedding.weight.grad._values().clone()
        scaler.minimize(opt)  # unscales the gradients in place, then steps
        if scaler._found_inf_last:
            fail(f"Wide&Deep fp16 on {w}: the step from 2^10 overflowed")
        grad = model.embedding.weight.grad
        if not torch.equal(grad._values() * WD_SCALE, scaled):
            fail(f"Wide&Deep fp16 on {w}: the table's values are not the "
                 "scaled ones over 2^10")
        after[side] = (model, SelectedRows.from_grad(grad).merged(),
                       SelectedRows(grad._indices()[0], scaled,
                                    grad.shape[0]).merged())
    gm, gs, g_scaled = after["card"]
    cm, cs, _ = after["cpu"]
    if not torch.equal(gs.rows.cpu(), cs.rows.cpu()):
        fail("Wide&Deep fp16: the unscaled table rows differ")

    def rel(v):
        return float((v.cpu().double() - cs.values.double()).norm()) / \
            max(float(cs.values.double().norm()), 1e-30)
    got, control = rel(gs.values), rel(g_scaled.values)
    if not got <= WD_FP16_REL:
        fail(f"Wide&Deep fp16: the unscaled table values differ by {got:.3e} "
             f"of their norm (tol {WD_FP16_REL:.3e})")
    if control <= WD_FP16_REL:
        fail("Wide&Deep fp16: the values left scaled pass the tolerance")
    pw = hold_params("Wide&Deep fp16 step", gm, cm, WD_LR)
    say("sparse-cf", f"Wide&Deep fp16 GradScaler: from 2^32 the backward "
        "overflows and the step is skipped on the card and the CPU port "
        "(parameters bitwise unchanged, no accumulator made, scale halved); "
        "from 2^10 the table's values are the scaled ones over 2^10 exactly "
        f"on each side, and agree card vs CPU port to {got:.3e} of their "
        f"norm (tol {WD_FP16_REL:.3e}; left scaled: {control:.3e}), "
        f"parameters after within {pw:.3f} of 2.5 lr")


def wd_main_path(device, state, batches, cfg, steps=WD_STEPS):
    """(i) the main path: ``steps`` Adam(WD_LR) steps on the card cycling
    over ``batches``, the kernels' counts set to 0 before and read after,
    the sparse and densified update counts. Returns (losses, counts,
    model, opt, sparse updates, densified updates)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch import optimizer as T
    model = wd_model(state, device, cfg)
    opt = T.Adam(WD_LR, parameters=list(model.parameters()))
    on = [wd_on(b, device) for b in batches]
    monitor.reset_all()
    reset_counts()
    losses = [wd_step(model, opt, on[k % len(on)])[0] for k in range(steps)]
    counts = read_counts()
    losses = [float(v) for v in losses]
    return (losses, counts, model, opt,
            monitor.stat_get("STAT_optimizer_sparse_update"),
            monitor.stat_get("STAT_optimizer_densified_update"))


def run_wide_deep(device, card, cfg=None, b=WD_B, steps=WD_STEPS):
    """Phase 12 (i). Returns the main path's kernel counts."""
    cfg = dict(cfg or {})
    t0 = time.perf_counter()
    state = wd_state(cfg)
    vocab = cfg.get("sparse_feature_number", 100000)
    slots = cfg.get("num_sparse_slots", 26)
    dim = cfg.get("sparse_feature_dim", 16)
    batches = wd_batches(4, b, slots, vocab)
    check_wd_vs_cpu(device, state, batches, cfg)
    say("sparse-cf", f"Wide&Deep checks against the CPU port in "
        f"{time.perf_counter() - t0:.1f} s")
    losses, counts, model, opt, n_sparse, n_dense = wd_main_path(
        device, state, batches, cfg, steps)
    if any(counts.values()):
        fail(f"Wide&Deep main path launched kernels: {counts}")
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not all(math.isfinite(v) for v in losses) or not last < first:
        fail(f"Wide&Deep main path: losses {losses}")
    if n_sparse != steps or n_dense != 0:
        fail(f"Wide&Deep main path: {n_sparse} sparse and {n_dense} "
             f"densified table updates in {steps} steps")
    table = model.embedding.weight.detach().cpu()
    touched = np.unique(np.concatenate(
        [batches[k % len(batches)][0].ravel() for k in range(steps)]))
    untouched = np.setdiff1d(np.arange(vocab), touched)
    init = torch.from_numpy(state["embedding.weight"])
    if not torch.equal(table[untouched], init[untouched]):
        fail("Wide&Deep main path: a row never touched moved")
    again = wd_main_path(device, state, batches, cfg, steps)
    diff = max(float((p.detach() - q.detach()).abs().max()) for p, q in
               zip(model.parameters(), again[2].parameters()))
    if again[0] != losses or diff != 0.0:
        fail(f"Wide&Deep rerun: losses {again[0]} against {losses}, "
             f"parameters off by up to {diff}")
    say("sparse-cf", f"Wide&Deep main path {cfg or 'WideDeep() defaults'}, "
        f"B={b}, {steps} Adam({WD_LR:g}) steps over {len(batches)} "
        "batches: losses " + " ".join(f"{v:.5f}" for v in losses) +
        f"; {n_sparse:g} sparse table updates, {n_dense:g} densified; "
        f"{len(untouched)} rows never touched bitwise unchanged; kernels "
        f"launched {counts}; a rerun from the same seed is bitwise equal")
    del again
    # times: step ms on the host clock (synchronised, median of 10), the
    # device busy ms of one profiled step, the rows a step touches
    on = [wd_on(x, device) for x in batches]
    for k in range(2):
        wd_step(model, opt, on[k])
    torch.cuda.synchronize()
    times = []
    for k in range(10):
        t = time.perf_counter()
        wd_step(model, opt, on[k % len(on)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    ms = 1e3 * float(np.median(times))
    busy, n_kernels, _, _ = profile_step(lambda: wd_step(model, opt, on[0]))
    uniq = [len(np.unique(x[0])) for x in batches]
    n_ids = b * slots
    row = dim * 4
    lazy = [u * row * 6 + n_ids * row for u in uniq]
    dense = vocab * row * 7
    say("sparse-cf", f"times Wide&Deep B={b}: step {ms:.2f} ms median of 10 "
        f"({1e3 * min(times):.2f}-{1e3 * max(times):.2f}), device busy "
        f"{busy:.3f} ms in {n_kernels} kernels, idle share "
        f"{max(0.0, 1.0 - busy / ms):.3f}; unique rows a step {uniq} of "
        f"{n_ids} ids; the lazy Adam update touches "
        f"{np.mean(lazy) / 1e6:.2f} MB a step (p, m1, m2 read and written a "
        f"row, the {n_ids} gradient rows read) against {dense / 1e6:.2f} MB "
        f"for a dense Adam over the table  [{card}]")
    return counts


# -- (ii) the LSTM language model
# one step, card against the CPU port, with the same dropout masks (both
# draw from the executor's CPU generator): fp32 through 35 recurrent steps
# and a 10000-way softmax in other orders. Loss within 1e-5 relative, each
# @GRAD at STEP_TOL, each weight's change from the step within UPDATE_RTOL
# of the CPU's in norm (SGD(1.0) moves a weight by its clipped gradient).
LM_EMA_STEPS = 3


def lm_run(form, state, device, feeds, steps, fetch=(), mode=True,
           ema=None, keep=False):
    """``steps`` steps of the LM program from ``state``: (executor, scope,
    the loss of each step (a fetch as ``mode`` returns it), the fetches)
    and, with ``keep``, each step's clone of the scope's weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import load_reference_scope
    main, _, loss = form
    scope, exe = pt.Scope(), pt.Executor(device)
    load_reference_scope(scope, state, device)
    out, kept = [], []
    for k in range(steps):
        vals = exe.run(main, feed=feeds[k % len(feeds)],
                       fetch_list=[loss.name, *fetch], scope=scope,
                       return_numpy=mode)
        if ema is not None:
            ema.update(scope, main)
        out.append(vals)
        if keep:
            kept.append({n: scope.find_var(n).detach().clone()
                         for n in fetch if scope.find_var(n) is not None})
    return exe, scope, out, kept


def run_lm(device, card, cfg=None, steps=LM_STEPS):
    """Phase 12 (ii). Returns the main path's kernel counts."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import monitor
    cfg = dict(LM_CFG if cfg is None else cfg)
    t0 = time.perf_counter()
    form = build_lstm_lm(pt, **cfg)
    main, startup, loss = form
    main.random_seed = LM_SEED
    startup.random_seed = LM_SEED
    state = static_state(startup, torch.device("cpu"))
    feeds = lm_feeds(steps, cfg["vocab"], cfg["steps"], cfg["batch"])
    params = [v.name for v in main.all_parameters()]
    grads = [n + "@GRAD" for n in params]
    cpu = torch.device("cpu")
    (gexe, gscope, gout, _), (_, cscope, cout, _) = (
        lm_run(form, state, w, feeds, 1, grads, mode=False)
        for w in (device, cpu))
    lg, lc = float(gout[0][0]), float(cout[0][0])
    if not math.isfinite(lg) or abs(lg - lc) > 1e-5 * abs(lc):
        fail(f"LM step: loss {lg} on the card, {lc} on the CPU port")
    gw = hold_grads("LM step", dict(zip(grads, gout[0][1:])),
                    dict(zip(grads, cout[0][1:])))
    worst = 0.0
    for n in params:
        d_g = gscope.find_var(n).double().cpu() - torch.from_numpy(
            state[n]).double()
        d_c = cscope.find_var(n).double() - torch.from_numpy(
            state[n]).double()
        rel = float((d_g - d_c).norm()) / max(float(d_c.norm()), 1e-30)
        worst = max(worst, rel / UPDATE_RTOL)
        if not rel <= UPDATE_RTOL:
            fail(f"LM step: the change of {n} is {rel:.3e} of its norm away")
    n_ops = sum(gexe.lowered.values())
    say("sparse-cf", f"LSTM LM {cfg} through StaticRNN, one step card vs CPU "
        f"port with the same dropout masks: loss {lg:.6f} / {lc:.6f} "
        f"(ln {cfg['vocab']} = {math.log(cfg['vocab']):.6f}); "
        f"{len(grads)} @GRAD at {gw:.3f} of STEP_TOL; each weight's change "
        f"within {worst:.3f} of {UPDATE_RTOL:g}; {n_ops} op lowerings a "
        f"step, host reads {gexe.host_syncs}; in "
        f"{time.perf_counter() - t0:.1f} s")
    del gscope, cscope

    # the main path: lazy fetches, counts set to 0 before, read after
    watch = "softmax.b"
    monitor.reset_all()
    reset_counts()
    exe, scope, lazy, kept = lm_run(form, state, device, feeds, steps,
                                    [watch], mode="lazy", keep=True)
    torch.cuda.synchronize()
    counts = read_counts()
    in_loop = monitor.stat_get("STAT_executor_sync")
    losses = [float(h[0]) for h in lazy]
    per_read = monitor.stat_get("STAT_executor_sync") - in_loop
    own = all(np.array_equal(np.asarray(h[1]), kept[k][watch].cpu().numpy())
              for k, h in enumerate(lazy))
    if any(counts.values()):
        fail(f"LM main path launched kernels: {counts}")
    if in_loop != 0 or per_read != steps:
        fail(f"LM lazy fetches: {in_loop} syncs in the loop, {per_read} for "
             f"{steps} loss reads")
    if not own:
        fail("LM lazy fetches: a weight fetched lazily did not read its own "
             "step's value")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < \
            losses[0]:
        fail(f"LM main path: losses {losses}")
    monitor.reset_all()
    _, _, eager, _ = lm_run(form, state, device, feeds, steps)
    eager_losses = [float(v[0]) for v in eager]
    if eager_losses != losses or \
            monitor.stat_get("STAT_executor_sync") != steps:
        fail(f"LM eager fetches: losses {eager_losses} against the lazy "
             f"{losses}; {monitor.stat_get('STAT_executor_sync')} syncs")
    say("sparse-cf", f"LSTM LM main path, {steps} SGD({cfg['lr']:g}) steps "
        f"under GradientClipByGlobalNorm({cfg['clip']:g}) with lazy fetches: "
        "losses " + " ".join(f"{v:.5f}" for v in losses) +
        f"; 0 syncs in the loop, {per_read:g} for the {steps} loss reads; "
        f"{watch} fetched lazily reads its own step's value; an eager-fetch "
        f"run gives the same losses bitwise with one sync a run; kernels "
        f"launched {counts}")

    # a static ExponentialMovingAverage, updated each step, applied for one
    # eval pass of the test clone and restored, card against CPU port
    evals = {}
    test = main.clone(for_test=True)
    for label, w in (("card", device), ("cpu", cpu)):
        ema = pt.optimizer.ExponentialMovingAverage(0.999)
        exe, scope, _, _ = lm_run(form, state, w, feeds, LM_EMA_STEPS,
                                  ema=ema)
        before = {n: scope.find_var(n) for n in params}
        with ema.apply(scope, main):
            evals[label] = (float(exe.run(test, feed=feeds[0],
                                           fetch_list=[loss.name],
                                           scope=scope)[0]),
                             scope.find_var(watch).cpu().clone())
        if any(scope.find_var(n) is not before[n] for n in params):
            fail(f"LM EMA on {w}: restore did not put the weights back")
    (eg, sg), (ec, sc) = evals["card"], evals["cpu"]
    if abs(eg - ec) > 1e-5 * abs(ec):
        fail(f"LM EMA eval: loss {eg} on the card, {ec} on the CPU port")
    e = hold_tensor("LM EMA shadow", sg, sc, 1e-6)
    say("sparse-cf", f"LSTM LM static ExponentialMovingAverage(0.999) over "
        f"{LM_EMA_STEPS} steps: eval loss with the shadows {eg:.6f} / "
        f"{ec:.6f} (card / CPU port), {watch}'s shadow within {e:.2e}; "
        "restored after")

    # times
    exe, scope, _, _ = lm_run(form, state, device, feeds, 2)

    def step():
        return exe.run(main, feed=feeds[0], fetch_list=[loss.name],
                       scope=scope, return_numpy=False)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    ms = 1e3 * float(np.median(times))
    busy, n_kernels, _, _ = profile_step(step)
    say("sparse-cf", f"times LSTM LM: step {ms:.2f} ms median of 5 "
        f"({1e3 * min(times):.2f}-{1e3 * max(times):.2f}), device busy "
        f"{busy:.2f} ms in {n_kernels} kernels, idle share "
        f"{max(0.0, 1.0 - busy / ms):.3f}; {sum(exe.lowered.values())} op "
        f"lowerings a step, {exe.host_syncs} host syncs a step  [{card}]")
    return counts


# -- (iii) the structural ops, then three LeNet steps of the proximal rules
# and a static ModelAverage, card against CPU port (hold_steps' tolerances)
PROX_RULES = {"proximal_gd": (lambda f: f.optimizer.SGD(0.01), "sgd",
                              0.01),
              "proximal_adagrad": (lambda f: f.optimizer.Adagrad(
                  0.01, initial_accumulator_value=0.1), "adagrad", 0.01)}


def check_lenet_extras(device):
    from paddle_tpu_torch import fluid
    feeds = lenet_feeds(LENET_B, RULE_STEPS)
    for name, (make, replaced, lr) in PROX_RULES.items():
        form, _, _ = build_lenet(fluid, make)
        for op in form[0].global_block.ops:
            if op.type == replaced:
                op.type = name
                op.attrs.update(l1=1e-4, l2=1e-3)
        state = static_state(form[1], fluid.CPUPlace())
        g, exe = program_steps(form, state, fluid.CUDAPlace(0), feeds,
                               steps=RULE_STEPS)
        c, _ = program_steps(form, state, fluid.CPUPlace(), feeds,
                             steps=RULE_STEPS)
        worst = hold_steps(f"sparse-cf {name}", g, c, state, lr)
        say("sparse-cf", f"LeNet {name}: {RULE_STEPS} steps card vs CPU "
            "port, losses " + " ".join(f"{r['loss']:.6f}" for r in g) +
            f"; {exe.lowered[name]} {name} ops a step; persistables within "
            f"{worst['param']:.3f} of 2.5 lr, changes at "
            f"{worst['update']:.3f} of {UPDATE_RTOL:g}")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import load_reference_scope
    form, _, _ = build_lenet(fluid)
    main, startup, loss = form
    state = static_state(startup, fluid.CPUPlace())
    test = main.clone(for_test=True)
    out = {}
    for label, w in (("card", device), ("cpu", torch.device("cpu"))):
        scope, exe = pt.Scope(), pt.Executor(w)
        load_reference_scope(scope, state, w)
        avg = pt.optimizer.ModelAverage(0.5, min_average_window=2,
                                        max_average_window=2)
        for k in range(RULE_STEPS):
            exe.run(main, feed=feeds[k], fetch_list=[loss], scope=scope)
            avg.update(scope, main)
        with avg.apply(scope, main):
            ev = float(exe.run(test, feed=feeds[0], fetch_list=[loss],
                               scope=scope)[0])
            ws = {v.name: scope.find_var(v.name).cpu().clone()
                  for v in main.all_parameters()}
        out[label] = (ev, ws)
    (eg, wg), (ec, wc) = out["card"], out["cpu"]
    if abs(eg - ec) > 1e-5 * abs(ec):
        fail(f"LeNet ModelAverage eval: {eg} on the card, {ec} on the CPU")
    worst = max(hold_tensor(f"ModelAverage {n}", wg[n], wc[n],
                            2.5 * LENET_LR) for n in wc)
    say("sparse-cf", f"LeNet static ModelAverage over {RULE_STEPS} Adam "
        f"steps (window 2): eval loss with the averages {eg:.6f} / {ec:.6f}, "
        f"averaged weights within {worst:.2e} (tol 2.5 lr)")


def run_sparse_cf(device, card):
    """Phase 12. Returns the kernel counts of its two main paths."""
    t0 = time.perf_counter()
    wd_counts = run_wide_deep(device, card)
    torch.cuda.empty_cache()
    say("sparse-cf", f"Wide&Deep in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_counts = run_lm(device, card)
    torch.cuda.empty_cache()
    say("sparse-cf", f"LSTM LM in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reads = check_control_flow(device)
    check_lenet_extras(device)
    say("sparse-cf", f"control flow ({reads} host reads in all) and the "
        f"LeNet rules in {time.perf_counter() - t0:.1f} s")
    return wd_counts, lm_counts


# -- phase 13: datasets, CompiledProgram and the 2.0 front door

# (i) the Wide&Deep epoch from MultiSlot files: WideDeep()'s widths as a
# static program, DS_N instances (ids Zipf(1.2) as in wd_batches) in
# DS_FILES files, one epoch at B=WD_B with Adam(WD_LR)
DS_N = 20480
DS_FILES = 4
DS_SEED = 77
DS_RESULTS_WINDOW = 4


def build_wd_program(pt, vocab=100000, dim=16, slots=26, dense_dim=13,
                     fc_sizes=(400, 400, 400), lr=WD_LR, seed=WD_SEED):
    """Wide&Deep as a static program built with package ``pt``, the
    network of models/wide_deep.py: the slots C0..C{slots-1} (int64 [B, 1]
    each, one id an instance) looked up in one [vocab, dim] table, their
    rows beside the dense features through fc 400-400-400 (relu) to a
    logit, plus a linear map of the dense features; the mean sigmoid
    cross-entropy against ``label``, minimized by Adam(lr). Returns (main,
    startup, the feed vars in slot order, the loss)."""
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.program_guard(main, startup):
        L = pt.layers
        ids = [L.data(f"C{s}", [1], dtype="int64") for s in range(slots)]
        dense = L.data("dense", [dense_dim])
        label = L.data("label", [1])
        emb = L.embedding(L.reshape(L.concat(ids, axis=1), [-1, slots, 1]),
                          size=[vocab, dim], is_sparse=True,
                          param_attr="embedding.weight")
        h = L.concat([dense, L.reshape(emb, [-1, slots * dim])], axis=1)
        for k, size in enumerate(fc_sizes):
            h = L.fc(h, size, act="relu", param_attr=f"deep.{2 * k}.weight",
                     bias_attr=f"deep.{2 * k}.bias")
        k = 2 * len(fc_sizes)
        deep = L.fc(h, 1, param_attr=f"deep.{k}.weight",
                    bias_attr=f"deep.{k}.bias")
        wide = L.fc(dense, 1, param_attr="wide.weight", bias_attr="wide.bias")
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(
            L.elementwise_add(wide, deep), label))
        pt.optimizer.Adam(lr).minimize(loss, startup_program=startup)
    return main, startup, ids + [dense, label], loss


def write_wd_files(dataset_mod, root, n=DS_N, files=DS_FILES, slots=26,
                   vocab=100000, dense_dim=13, seed=DS_SEED):
    """``n`` instances written by ``dataset_mod.MultiSlotDataGenerator`` in
    MultiSlot text into ``files`` files under ``root``: per instance one
    id a slot (Zipf(1.2) folded into the table), the dense features
    N(0, 1) as float32 and a label 1 where a fixed random linear map of
    them is positive. Returns the paths."""
    rng = np.random.default_rng(seed)
    rule = rng.standard_normal(dense_dim).astype(np.float32)
    ids = ((rng.zipf(1.2, (n, slots)) - 1) % vocab).astype(np.int64)
    dense = rng.standard_normal((n, dense_dim)).astype(np.float32)
    label = (dense @ rule > 0).astype(np.float32)

    class Gen(dataset_mod.MultiSlotDataGenerator):
        def generate_sample(self, i):
            def rec():
                yield ([(f"C{s}", [int(ids[i, s])]) for s in range(slots)] +
                       [("dense", [float(v) for v in dense[i]]),
                        ("label", [float(label[i])])])
            return rec

    paths = []
    per = n // files
    for f in range(files):
        lines = Gen().run_from_memory(range(f * per, (f + 1) * per))
        path = os.path.join(root, f"part-{f:05d}")
        with open(path, "w") as out:
            out.write("\n".join(lines) + "\n")
        paths.append(path)
    return paths


def wd_dataset(pt, feeds, paths, b=WD_B, kind="InMemoryDataset",
               seed=DS_SEED):
    """A dataset of package ``pt`` over ``paths``: loaded and shuffled by
    ``local_shuffle(seed)`` when in memory."""
    ds = pt.dataset.DatasetFactory().create_dataset(kind)
    ds.set_use_var(feeds)
    ds.set_filelist(paths)
    ds.set_batch_size(b)
    ds.set_thread(len(paths))
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        ds.local_shuffle(seed)
    return ds


def dataset_epoch(exe, main, ds, state, device, loss, window=2):
    """One train_from_dataset epoch from ``state`` with ``window`` steps in
    flight: (the losses, the parameters after, the epoch's seconds)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import load_reference_scope
    scope = pt.Scope()
    load_reference_scope(scope, state, device)
    before = pt.get_flags("FLAGS_executor_inflight_steps")
    pt.set_flags({"FLAGS_executor_inflight_steps": window})
    try:
        t = time.perf_counter()
        out = exe.train_from_dataset(main, ds, scope=scope,
                                     fetch_list=[loss])
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    finally:
        pt.set_flags(before)
    return ([float(r[0]) for r in out],
            {v.name: scope.find_var(v.name).detach().cpu().clone()
             for v in main.all_parameters()}, seconds)


def fed_epoch(exe, main, ds, state, device, loss):
    """The dataset's batches fed one by one through ``exe.run``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.scope import load_reference_scope
    scope = pt.Scope()
    load_reference_scope(scope, state, device)
    losses = [float(exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0])
              for b in ds]
    return losses, {v.name: scope.find_var(v.name).detach().cpu().clone()
                    for v in main.all_parameters()}


def params_equal(a, b):
    return all(torch.equal(a[n], b[n]) for n in a)


def run_dataset_epoch(device, card, cfg=None, n=DS_N, b=WD_B):
    """Phase 13 (i): files written, loaded by the native parser, one epoch
    through train_from_dataset at window 2 and 1 and fed through run, all
    bitwise equal; times; infer_from_dataset's result windows."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.dataset import native
    cfg = dict(cfg or {})
    vocab = cfg.get("vocab", 100000)
    main, startup, feeds, loss = build_wd_program(pt, **cfg)
    state = static_state(startup, device)
    exe = pt.Executor(device)
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        paths = write_wd_files(pt.dataset, root, n=n, vocab=vocab,
                               slots=cfg.get("slots", 26),
                               dense_dim=cfg.get("dense_dim", 13))
        write_s = time.perf_counter() - t
        before = dict(native.PARSES)
        t = time.perf_counter()
        ds = wd_dataset(pt, feeds, paths, b)
        parse_s = time.perf_counter() - t
        parsed = {k: native.PARSES[k] - before[k] for k in before}
        if not native.using_native() or parsed != {"native": len(paths),
                                                   "python": 0}:
            fail(f"dataset: the native MultiSlot parser did not read the "
                 f"files (using_native {native.using_native()}, parses "
                 f"{parsed})")
        if ds.get_memory_data_size() != n:
            fail(f"dataset: {ds.get_memory_data_size()} instances loaded of "
                 f"{n}")
        steps = -(-n // b)
        w2, p2, s2 = dataset_epoch(exe, main, ds, state, device, loss, 2)
        w1, p1, s1 = dataset_epoch(exe, main, ds, state, device, loss, 1)
        fed, pf = fed_epoch(exe, main, ds, state, device, loss)
        if len(w2) != steps or not all(math.isfinite(v) for v in w2):
            fail(f"dataset epoch: losses {w2}")
        if w2 != fed or not params_equal(p2, pf):
            fail("dataset epoch (window 2) differs from the batches fed "
                 f"through run: losses {w2} against {fed}")
        if w1 != w2 or not params_equal(p1, p2):
            fail(f"dataset epoch: window 1 {w1} differs from window 2 {w2}")
        if not np.mean(w2[-4:]) < np.mean(w2[:4]):
            fail(f"dataset epoch: the loss does not fall: {w2}")
        say("dataset", f"Wide&Deep {cfg or 'WideDeep() widths'} as a static "
            f"program: {n} instances written by MultiSlotDataGenerator into "
            f"{len(paths)} files in {write_s:.2f} s, loaded by the native "
            f"parser ({parsed['native']} files, 0 by the Python parser) and "
            f"local_shuffle({DS_SEED}); one train_from_dataset epoch of "
            f"{steps} Adam({WD_LR:g}) steps at B={b}: losses "
            + " ".join(f"{v:.6f}" for v in w2) + "; bitwise equal to the "
            "same batches fed one by one through exe.run (losses and every "
            f"parameter), and window 1 bitwise equal to window 2  [{card}]")
        # times: the epoch at window 2 and 1, its device busy time
        runs = {2: [], 1: []}
        for _ in range(2):
            for w in (2, 1):
                runs[w].append(dataset_epoch(exe, main, ds, state, device,
                                             loss, w)[2])
        scope = pt.Scope()
        from paddle_tpu_torch.core.scope import load_reference_scope
        load_reference_scope(scope, state, device)
        busy, n_kernels, _, _ = profile_step(lambda: exe.train_from_dataset(
            main, ds, scope=scope, fetch_list=[loss]))
        ms2 = 1e3 * min(runs[2])
        ms1 = 1e3 * min(runs[1])
        say("dataset", f"times: parse {1e3 * parse_s:.1f} ms for {n} "
            f"instances on {len(paths)} threads (load_into_memory + "
            f"local_shuffle, host); epoch {ms2:.1f} ms at window 2 "
            f"({', '.join(f'{1e3 * s:.1f}' for s in runs[2])}), {ms1:.1f} "
            f"ms at window 1 ({', '.join(f'{1e3 * s:.1f}' for s in runs[1])})"
            f"; step {ms2 / steps:.2f} ms at window 2, {ms1 / steps:.2f} at "
            f"window 1; device busy {busy:.2f} ms an epoch in {n_kernels} "
            f"kernels, idle share {max(0.0, 1 - busy / ms2):.3f} at window "
            f"2, {max(0.0, 1 - busy / ms1):.3f} at window 1  [{card}]")
        # infer_from_dataset: a for_test clone; all results, none, the last
        # DS_RESULTS_WINDOW
        qds = wd_dataset(pt, feeds, paths, b, "QueueDataset")
        scope = pt.Scope()
        load_reference_scope(scope, state, device)
        every = exe.infer_from_dataset(main, qds, scope=scope,
                                       fetch_list=[loss])
        none = exe.infer_from_dataset(main, qds, scope=scope,
                                      fetch_list=[loss], keep_results=False)
        pt.set_flags({"FLAGS_dataset_results_window": DS_RESULTS_WINDOW})
        try:
            last = exe.infer_from_dataset(main, qds, scope=scope,
                                          fetch_list=[loss])
        finally:
            pt.set_flags({"FLAGS_dataset_results_window": 0})
        moved = [n_ for n_, v in p2.items()
                 if not torch.equal(scope.find_var(n_).cpu(),
                                    torch.from_numpy(state[n_]))]
        if len(every) != steps or none is not None or \
                [float(r[0]) for r in last] != \
                [float(r[0]) for r in every[-DS_RESULTS_WINDOW:]] or moved:
            fail(f"infer_from_dataset: {len(every)} results, keep_results="
                 f"False gave {none!r}, the window gave {len(last)}, "
                 f"parameters moved: {moved[:3]}")
        say("dataset", f"infer_from_dataset over the same files "
            f"(QueueDataset, the program's for_test clone): {len(every)} "
            f"batches, losses {float(every[0][0]):.6f}..."
            f"{float(every[-1][0]):.6f}; keep_results=False returns None; "
            f"FLAGS_dataset_results_window={DS_RESULTS_WINDOW} keeps the "
            f"last 4, equal to the full run's; no parameter moved  [{card}]")


def compiled_run(form, state, device, b, steps):
    """amp_run's ``steps`` steps through CompiledProgram(main)
    .with_data_parallel(loss_name), counts set to 0 just before and read
    just after."""
    from paddle_tpu_torch.compiler import CompiledProgram
    run = StaticRun(form, state, device, b)
    prog = CompiledProgram(run.main).with_data_parallel(loss_name=run.loss)
    reset_counts()
    reset_static_logs()
    losses = []
    with LaunchDtypes() as seen:
        for _ in range(steps):
            losses.append(run.exe.run(prog, feed=run.feed,
                                      fetch_list=[run.loss], scope=run.scope,
                                      return_numpy=False)[0])
        torch.cuda.synchronize()
    counts, paths = read_counts(), static_paths()
    return dict(losses=[float(x) for x in losses], counts=counts,
                paths=paths, dtypes=seen.seen, params=run.params(), seq=[])


def run_compiled(device, card):
    """Phase 13 (ii): form (d) in bf16 through CompiledProgram against the
    plain program. Returns the compiled run's launch counts."""
    import paddle_tpu_torch as pt
    form, _ = amp_form(pt, "bfloat16")
    state = static_state(form[1], device)
    plain = amp_run(form, state, device, STATIC_B, STATIC_STEPS)
    comp = compiled_run(form, state, device, STATIC_B, STATIC_STEPS)
    per = check_amp_run(comp, "dataset CompiledProgram (d) bf16", "bfloat16",
                        STATIC_STEPS)
    diff = max(float((plain["params"][n] - comp["params"][n]).abs().max())
               for n in plain["params"])
    if comp["losses"] != plain["losses"] or diff != 0.0:
        fail(f"CompiledProgram (d): losses {comp['losses']} against the "
             f"plain program's {plain['losses']}, parameters off by {diff}")
    say("dataset", f"CompiledProgram(main).with_data_parallel(loss_name) of "
        f"form (d) {STATIC_CFG} bf16, {STATIC_STEPS} steps at B={STATIC_B}: "
        "losses " + " ".join(f"{v:.8f}" for v in comp["losses"]) + "; "
        "bitwise equal to the plain program's losses and parameters; "
        "launches a step " + ", ".join(f"{k} {v}" for k, v in per.items())
        + f"; flash on {sorted(comp['dtypes']['flash_attention_fwd'])}; path "
        f"logs {len(comp['paths'][0])} x 'flash', {len(comp['paths'][1])} x "
        f"'kernel'  [{card}]")
    return comp["counts"]


def nan_program(pt):
    """y = log(x) and z = x * 2 over a feed x [4]: (main, y, z)."""
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data("x", [4])
        y = pt.layers.log(x)
        z = pt.layers.scale(x, scale=2.0)
    return main, y, z


def grads_seeded(pt, device):
    """d(sum(t1 * s1) + sum(t2 * s2))/d(x, h) through
    gradients(target_gradients=), t1 = fc(x) and t2 = tanh(t1): a list of
    numpy arrays (x a feed, h the intermediate t1)."""
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [6])
        s1 = pt.layers.data("s1", [3])
        s2 = pt.layers.data("s2", [3])
        t1 = pt.layers.fc(x, 3, param_attr="w", bias_attr="b")
        t2 = pt.layers.tanh(t1)
        grads = pt.gradients([t1, t2], [x, t1], target_gradients=[s1, s2])
    rng = np.random.default_rng(9)
    feed = {n: rng.standard_normal((4, d)).astype(np.float32)
            for n, d in (("x", 6), ("s1", 3), ("s2", 3))}
    scope = pt.Scope()
    exe = pt.Executor(device)
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=grads, scope=scope)


def check_executor_checks(device, card):
    """Phase 13 (iii): FLAGS_check_nan_inf raises naming the op; the fast
    check reads the host once a run; gradients(target_gradients=) on the
    card against the CPU port."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.core.enforce import EnforceNotMet
    main, y, z = nan_program(pt)
    exe = pt.Executor(device)
    feed = {"x": np.array([[0.0, 1.0, 2.0, 3.0]], np.float32)}
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        exe.run(main, feed=feed, fetch_list=[z, y], scope=pt.Scope())
    except EnforceNotMet as e:
        raised = str(e)
    else:
        raised = None
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})
    if raised is None or "'log'" not in raised or y.name not in raised:
        fail(f"check_nan_inf on {device}: log(0) gave {raised!r}")
    pt.set_flags({"FLAGS_fast_check_nan_inf": True})
    try:
        monitor.reset_all()
        for _ in range(3):
            exe.run(main, feed={"x": feed["x"] + 1}, fetch_list=[z, y],
                    scope=pt.Scope(), return_numpy=False)
        syncs = monitor.stat_get("STAT_executor_sync")
        try:
            exe.run(main, feed=feed, fetch_list=[z, y], scope=pt.Scope(),
                    return_numpy=False)
            fast = None
        except EnforceNotMet as e:
            fast = str(e)
    finally:
        pt.set_flags({"FLAGS_fast_check_nan_inf": False})
    if syncs != 3 or fast is None or y.name not in fast:
        fail(f"fast_check_nan_inf on {device}: {syncs} host reads in 3 "
             f"runs, the -inf fetch gave {fast!r}")
    # one startup seed draws the same weights on the card and the CPU
    got = grads_seeded(pt, device)
    want = grads_seeded(pt, torch.device("cpu"))
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    if not err <= 1e-5:
        fail(f"gradients(target_gradients=) on {device} against the CPU "
             f"port: max error {err}")
    say("dataset", f"check_nan_inf raises on the card: {raised}; "
        "fast_check_nan_inf reads the host once a run (3 reads in 3 runs) "
        f"and names the fetch: {fast}; gradients(target_gradients=) of two "
        f"seeded targets on the card against the CPU port: max error "
        f"{err:.2e} (tol 1e-5)  [{card}]")


EXAMPLE_MODULES = ("", ".nn", ".nn.functional", ".jit", ".models",
                   ".models.bert")


def example_on_port(path):
    """The example file at ``path`` run as a module with the port in place
    of paddle_tpu: ``paddle_tpu`` and each of EXAMPLE_MODULES under it
    bound to the port's module of the same name while it imports, so
    nothing of the JAX package is imported."""
    import importlib
    import importlib.util

    names = {"paddle_tpu" + m: importlib.import_module("paddle_tpu_torch" + m)
             for m in EXAMPLE_MODULES}
    saved = {k: sys.modules.get(k) for k in names}
    sys.modules.update(names)
    try:
        spec = importlib.util.spec_from_file_location(
            "example_on_port_" + os.path.basename(path)[:-3], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if v is None:
                del sys.modules[k]
            else:
                sys.modules[k] = v
    return mod


CNN_EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "dygraph_cnn.py")
CNN_WORKERS = 2


def run_cnn_example(device, card, workers=CNN_WORKERS):
    """Phase 13 (iv): examples/dygraph_cnn.py's main as written on the
    port, its DataLoader given ``workers`` worker processes; every batch
    that reaches to_tensor is already a tensor on ``device``. Returns the
    losses printed."""
    import contextlib
    import io as _io

    import paddle_tpu_torch as pt
    mod = example_on_port(CNN_EXAMPLE)
    seen = []
    to_tensor, loader = pt.to_tensor, pt.io.DataLoader

    class WorkerLoader(loader):
        def __init__(self, *a, **k):
            k.setdefault("num_workers", workers)
            k.setdefault("timeout", 120)  # a stuck worker raises, not hangs
            super().__init__(*a, **k)

    def recording(x, *a, **k):
        seen.append(x.device if isinstance(x, torch.Tensor) else type(x))
        return to_tensor(x, *a, **k)
    if pt.device.resolve(None) != device:
        fail(f"dygraph_cnn: the default device is not {device}")
    pt.to_tensor, pt.io.DataLoader = recording, WorkerLoader
    out = _io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        pt.to_tensor, pt.io.DataLoader = to_tensor, loader
    seconds = time.perf_counter() - t
    losses = [float(ln.split("loss ")[1]) for ln in out.getvalue().splitlines()
              if ln.startswith("step")]
    if len(losses) < 2 or not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"dygraph_cnn on the port: losses {losses}")
    if not seen or any(d != device for d in seen):
        fail(f"dygraph_cnn: batches reached to_tensor on {set(seen)}, not "
             f"already on {device}")
    say("dataset", f"examples/dygraph_cnn.py main on the port ({device}), "
        f"DataLoader with {workers} worker processes and device prefetch: "
        f"losses " + " ".join(f"{v:.4f}" for v in losses) + f" in "
        f"{seconds:.1f} s; all {len(seen)} batches reached to_tensor "
        f"already on {device}  [{card}]")
    return losses


def run_front_door(device, card):
    """Phase 13. Returns the launch counts of its kernel path
    (CompiledProgram's form (d))."""
    t0 = time.perf_counter()
    run_dataset_epoch(device, card)
    torch.cuda.empty_cache()
    say("dataset", f"(i) in {time.perf_counter() - t0:.1f} s  [{card}]")
    t0 = time.perf_counter()
    counts = run_compiled(device, card)
    torch.cuda.empty_cache()
    say("dataset", f"(ii) in {time.perf_counter() - t0:.1f} s  [{card}]")
    t0 = time.perf_counter()
    check_executor_checks(device, card)
    run_cnn_example(device, card)
    say("dataset", f"(iii) and (iv) in {time.perf_counter() - t0:.1f} s  "
        f"[{card}]")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.jit import load_reference_state
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn.functional import (layer_norm_paths_taken,
                                                reset_layer_norm_path_log)
    from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                                 reset_attention_path_log)

    # -- 1. setup
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say("setup", f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("setup", "torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        "torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    built = _build.build()
    for name, (seconds, log) in built.items():
        say("setup", f"nvcc {' '.join(_build.NVCC_FLAGS)} csrc/{name}.cu: "
            f"{seconds:.1f} s -> {_build.library_path(name).name}; "
            + (" | ".join(ptxas_summary(log)) or "already built"))
    say("setup", f"kernels built in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda", 0)

    # -- 2. kernel parity against the plain versions
    ln_err = check_layer_norm(device)
    fa_err = check_flash(device)
    check_flash_instances(device)
    check_routes(device)

    # -- 3. serving: the main path
    cfg = BertConfig()
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, device=device)
    state = random_state(model, SEED)
    load_reference_state(model, state)
    model.eval()
    say("serve", f"BERT-base {cfg} built on {kind} from numpy seed {SEED} "
        f"via load_reference_state in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 1)
    requests = {name: make_request(b, s, padded, cfg.vocab_size, device, rng)
                for name, b, s, padded in REQUESTS}

    LN.launches = 0
    FA.launches = 0
    FA.fwd_copies = 0
    reset_attention_path_log()
    reset_layer_norm_path_log()
    outputs, per_forward = serve(model, requests)
    ln_total, fa_total = LN.launches, FA.launches
    paths = attention_paths_taken()
    ln_paths = layer_norm_paths_taken()
    if FA.fwd_copies != 0:
        fail(f"serving copied {FA.fwd_copies} flash inputs before the "
             "launch; the projection's views are aligned")

    n_fwd = len(per_forward)
    n_ln = 2 * cfg.num_hidden_layers + 2
    for key, (ln_n, fa_n) in per_forward.items():
        say("serve", f"request {key[0]} {'bf16' if key[1] else 'fp32'}: "
            f"layer_norm launches {ln_n}, flash launches {fa_n}")
        if ln_n != n_ln or fa_n != cfg.num_hidden_layers:
            fail(f"{key}: expected {n_ln} layer-norm and "
                 f"{cfg.num_hidden_layers} flash launches per forward")
    if ln_total != n_ln * n_fwd or fa_total != cfg.num_hidden_layers * n_fwd:
        fail(f"launch totals {ln_total}, {fa_total} after {n_fwd} forwards")
    if ln_total == 0 or fa_total == 0:
        fail("a kernel of the main path was never launched")
    if set(paths) != {"flash"} or len(paths) != cfg.num_hidden_layers * n_fwd:
        fail(f"attention path log is not all 'flash': {sorted(set(paths))}")
    if set(ln_paths) != {"kernel"} or len(ln_paths) != ln_total:
        fail(f"layer-norm path log is not all 'kernel': "
             f"{sorted(set(ln_paths))} x {len(ln_paths)}")
    say("serve", f"{n_fwd} forwards: layer_norm launches {ln_total}, flash "
        f"launches {fa_total} with no input copied, path logs {len(paths)} "
        f"x 'flash', {len(ln_paths)} x 'kernel'")
    check_outputs(outputs, requests, cfg.vocab_size)
    say("serve", "all logits finite, shapes as expected")

    for name in requests:
        m32 = outputs[(name, False)][0].argmax(-1)
        m16 = outputs[(name, True)][0].argmax(-1)
        rate = float((m32 == m16).float().mean())
        say("serve", f"{name}: bf16 MLM argmax agrees with fp32 at "
            f"{rate:.4f} (min {ARGMAX_AGREEMENT_MIN})")
        if rate < ARGMAX_AGREEMENT_MIN:
            fail(f"{name}: bf16/fp32 argmax agreement {rate}")

    # fp32 on the card against the same model on the CPU (plain versions)
    cpu_model = BertForPretraining(cfg, device="cpu")
    load_reference_state(cpu_model, state)
    cpu_model.eval()
    small = {k: v[:2] for k, v in requests["b8_s128_full"].items()}
    gpu_out = answer(model, small, False)
    with torch.no_grad():
        cpu_out = cpu_model(**{k: v.cpu() for k, v in small.items()})
    for what, g, c in zip(("mlm", "nsp"), gpu_out, cpu_out):
        err, ok = max_err(g.cpu(), c, CPU_TOL["atol"], CPU_TOL["rtol"])
        say("serve", f"fp32 GPU vs CPU port, B=2 S=128, {what}: max error "
            f"{err:.3e} (tol {CPU_TOL['atol']:g} + {CPU_TOL['rtol']:g}|ref|)"
            f", max |logit| {float(c.abs().max()):.3f}")
        if not ok:
            fail(f"fp32 GPU {what} logits disagree with the CPU port: {err}")
    del cpu_model

    # -- 4. times
    ln_times = time_layer_norm(device, card)
    fa_times = time_flash(device, card)
    time_forward(model, requests, card)
    profile_forward(model, requests, card)
    del model, outputs
    torch.cuda.empty_cache()

    # -- 5. training
    # (i) the training path's kernels against their plain versions
    drop_rate = check_dropout_pattern(device)
    ln_bwd_err = check_layer_norm_bwd(device)
    fa_bwd_err = check_flash_bwd(device)
    torch.cuda.empty_cache()
    # (ii) one fp32 step on the card against the CPU port
    check_step_against_cpu(device, state, {})
    torch.cuda.empty_cache()
    # (iii) the main path: counts set to 0 just before, read just after
    train_counts, (tmodel, _, tstep) = check_main_path(device, state, cfg)
    torch.cuda.empty_cache()
    # (iv) times
    ln_bwd_times = time_layer_norm_bwd(device, card)
    fa_bwd_times = time_flash_bwd(device, card)
    train_batch_ = train_batch(TRAIN_B, TRAIN_S, TRAIN_M, cfg.vocab_size,
                               device, 0)
    time_train_step(tstep, train_batch_, cfg, card)
    del tmodel, tstep
    torch.cuda.empty_cache()

    # -- 6. the BERT training recipe: the fp16 main path's counts set to 0
    # just before its run, read just after
    recipe_counts = run_recipe(device, state, cfg, card)
    torch.cuda.empty_cache()

    # -- 7. the static Program path: the main path's counts (ten steps of
    # form (c)) set to 0 just before its run, read just after
    static_counts = run_static(device, card)
    torch.cuda.empty_cache()

    # -- 8. generation: counts set to 0 just before each pool run, read
    # just after
    paged_err, gen_recs, paged_times = run_generation(device, card)

    # -- 9. ResNet-50: the main path's counts (no kernel of the seven runs
    # on it) set to 0 just before its run, read just after
    torch.cuda.empty_cache()
    run_resnet(device, card)

    # -- 10. Paddle Inference: the pool's main path counts set to 0 just
    # before its warmup, read just after its traffic
    torch.cuda.empty_cache()
    infer_dir = tempfile.TemporaryDirectory()
    (infer_fa, infer_ln), _ = run_inference(device, card, infer_dir.name)

    # -- 10b. serving artifacts, warm starts and autotune, on phase 10's
    # bundle: the artifact process's counts set to 0 just before its
    # forwards, read just after
    torch.cuda.empty_cache()
    (art_fa, art_ln), _, _ = run_artifact(device, card, infer_dir.name)
    infer_dir.cleanup()

    # -- 11. static-graph training: the main path's counts (ten bf16 steps
    # of form (d)) set to 0 just before its run, read just after
    torch.cuda.empty_cache()
    train_static_counts, _, _ = run_static_train(device, card)

    # -- 12. sparse embeddings, LoD feeds, lazy fetches and control flow:
    # the counts of its two main paths (Wide&Deep, the LSTM LM; no kernel
    # of the seven lies on either) set to 0 just before each, read after
    torch.cuda.empty_cache()
    wd_counts, lm_counts = run_sparse_cf(device, card)
    sparse_counts = {k: wd_counts[k] + lm_counts[k] for k in wd_counts}

    # -- 13. datasets, CompiledProgram and the 2.0 front door: the counts of
    # its kernel path (ten bf16 steps of form (d) through CompiledProgram)
    # set to 0 just before its run, read just after
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    front_counts = run_front_door(device, card)
    say("dataset", f"phase 13 in {time.perf_counter() - t0:.1f} s  [{card}]")
    late_counts = {k: sparse_counts[k] + front_counts[k]
                   for k in sparse_counts}

    # -- 14. records: launches are the serving, training, recipe, static,
    # generation (chunked fp32 and int8 KV, two-phase, the two drafters'
    # runs, int8 and fp8 weights),
    # inference, artifact, static-training, sparse/control-flow and
    # CompiledProgram runs
    ln_rec = ln_times[(4096, 768, torch.float32)]
    fa_key = (8, 12, 512, 512, 64, True, False, torch.bfloat16)
    fa_rec = fa_times[fa_key]
    bwd_key = (TRAIN_B, 12, TRAIN_S, 64, False, torch.bfloat16, 1.0)
    kernels = [
        dict(name="layer_norm_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/layer_norm.cu",
             replaces="paddle_tpu/kernels/layer_norm.py:33",
             launches=ln_total + train_counts["layer_norm_fwd"] +
             recipe_counts["layer_norm_fwd"] +
             static_counts["layer_norm_fwd"] +
             train_static_counts["layer_norm_fwd"] +
             late_counts["layer_norm_fwd"] + sum(
                 r["counts"]["layer_norm"] for r in gen_recs.values()) +
             infer_ln + art_ln,
             max_abs_err=ln_err[(4096, 768, torch.float32, 1e-12)],
             **ln_rec),
        dict(name="layer_norm_bwd", route="cuda",
             source="paddle_tpu_torch/csrc/layer_norm.cu",
             replaces="paddle_tpu/kernels/layer_norm.py:46",
             launches=train_counts["layer_norm_bwd"] +
             recipe_counts["layer_norm_bwd"] +
             static_counts["layer_norm_bwd"] +
             train_static_counts["layer_norm_bwd"] +
             late_counts["layer_norm_bwd"],
             max_abs_err=ln_bwd_err[(16384, 768, torch.float32)],
             **ln_bwd_times[(16384, 768, torch.float32)]),
        dict(name="flash_attention_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:207",
             launches=fa_total + train_counts["flash_attention_fwd"] +
             recipe_counts["flash_attention_fwd"] +
             static_counts["flash_attention_fwd"] +
             train_static_counts["flash_attention_fwd"] +
             late_counts["flash_attention_fwd"] + infer_fa + art_fa,
             max_abs_err=fa_err[(*fa_key, "contiguous")], **fa_rec),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:364",
             launches=train_counts["flash_attention_bwd_dq"] +
             recipe_counts["flash_attention_bwd_dq"] +
             static_counts["flash_attention_bwd_dq"] +
             train_static_counts["flash_attention_bwd_dq"] +
             late_counts["flash_attention_bwd_dq"],
             max_abs_err=fa_bwd_err[(0, "dq")],
             **fa_bwd_times[(*bwd_key, "dq")]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:413",
             launches=train_counts["flash_attention_bwd_dkv"] +
             recipe_counts["flash_attention_bwd_dkv"] +
             static_counts["flash_attention_bwd_dkv"] +
             train_static_counts["flash_attention_bwd_dkv"] +
             late_counts["flash_attention_bwd_dkv"],
             max_abs_err=max(fa_bwd_err[(0, "dk")], fa_bwd_err[(0, "dv")]),
             **fa_bwd_times[(*bwd_key, "dkv")]),
        dict(name="paged_attention", route="cuda",
             source="paddle_tpu_torch/csrc/paged_attention.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:215",
             launches=sum(r["counts"]["paged"] for r in gen_recs.values()),
             max_abs_err=max(paged_err["fp32"],
                             paged_times["fp32"]["max_abs_err"]), **{
                 k: paged_times["fp32"][k] for k in KERNEL_TIME_KEYS}),
        dict(name="paged_attention_quant", route="cuda",
             source="paddle_tpu_torch/csrc/paged_attention.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:274",
             launches=sum(r["counts"]["paged_quant"]
                          for r in gen_recs.values()),
             max_abs_err=max(paged_err["int8"], paged_err["fp8"],
                             paged_times["int8"]["max_abs_err"],
                             paged_times["fp8"]["max_abs_err"]), **{
                 k: paged_times["int8"][k] for k in KERNEL_TIME_KEYS}),
    ]
    say("train", f"seed-mode drop rate {drop_rate:.5f} over "
        f"[{TRAIN_B},12,{TRAIN_S},{TRAIN_S}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
