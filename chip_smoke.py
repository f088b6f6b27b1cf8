#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero:

1. setup: the card's name and power limit, TF32 off, the CUDA kernels
   built from ``paddle_tpu_torch/csrc`` with nvcc for sm_90a;
2. kernel parity: each CUDA kernel against its plain PyTorch version on
   the card, at BERT-base shapes, with stated tolerances; every compiled
   instance of the flash forward (dtype x D x dropout mode x bias layout),
   seed mode bitwise equal to mask mode with ``philox_keep_mask`` and two
   wrong dropouts shown to fail the tolerance; then the routes, through
   the port's entry points on the card, with the path logs read back:
   ``MultiHeadAttention(256, 8)`` (head dim 32, "composed", as the JAX
   router composes it) with and without seed dropout, forward and every
   gradient against the CPU port; head dim 256 ("flash", refused by the
   wrapper with no launch and no plain version run: no instance yet); a
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
   forward also at the train shape, with and without seed dropout); the
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
   tiling); the train step's eager ms, tokens/s, MFU and device idle
   share, with a profiler breakdown;
6. generation, the third main path: the decoder of docs/generation.md
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
   step over profiled mixed steps, in fp32 and int8 KV;
7. one JSON line of kernel records, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
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
            short = re.search(r"\d+([a-z][a-z_]*_kernel)(?:I(.*?)EEv)?",
                              mangled)
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
# bf16 and fp16 gamma/beta, fp16 x, and rows past 4096 values (the wide
# kernels: more rows than the backward's 512 blocks, scalar loads, the
# widest row)
LN_EDGE_CASES = ((7, 130, torch.float32, False), (7, 130, torch.bfloat16, False),
                 (5, 4096, torch.bfloat16, True), (3, 2050, torch.float32, False),
                 (7, 130, torch.float16, False),
                 (64, 768, torch.float16, False),
                 (5, 4096, torch.float16, True),
                 (1030, 8192, torch.float32, False),
                 (5, 8194, torch.bfloat16, True),
                 (3, 65536, torch.float16, True))


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
    for d in (64, 128)
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
# terms in another order (partials of up to 32 rows, then 512 partials),
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
) + tuple(  # every fp16 instance, and misaligned fp16 inputs
    (2, 4, 200, 130, d, bias, bias == "pad", torch.float16, "contiguous",
     drop) for d in (64, 128) for drop in (None, "mask", "seed")
    for bias in ("pad", "full")) + (
    (1, 4, 100, 100, 64, None, True, torch.float16, "unaligned", "seed"),)
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
        if drop == "seed" and b == TRAIN_B and dtype == torch.bfloat16:
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


def refused(what, run):
    """run() on the card must raise the flash wrapper's refusal
    (TypeError or ValueError) before any flash launch."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                                 reset_attention_path_log)
    launched = (FA.launches, FA.launches_dq, FA.launches_dkv)
    reset_attention_path_log()
    try:
        run()
    except (TypeError, ValueError) as e:
        err = e
    else:
        fail(f"routes: {what} ran on the card; the flash kernels have no "
             "instance for it and must refuse it")
    log = attention_paths_taken()
    if (FA.launches, FA.launches_dq, FA.launches_dkv) != launched or \
            log[-1:] != ["flash"]:
        fail(f"routes: {what}: path log {log}, flash launches "
             f"{(FA.launches, FA.launches_dq, FA.launches_dkv)} from "
             f"{launched}")
    say("routes", f"{what}: path log {log[-1:]}, refused with no launch: "
        f"{type(err).__name__}: {str(err)[:90]}")


def check_routes(device):
    """The port's routes through its entry points on the card, each with
    its path log read back: head dim 32 (MultiHeadAttention(256, 8), which
    the JAX router composes) with and without seed dropout against the CPU
    port; head dim 256, which reaches the flash wrapper and its refusal (no
    instance yet); a 2-layer BERT forward under auto_cast(dtype="float16")
    on the fp16 flash and layer-norm instances against the fp32 CPU port;
    layer norms over 8192 features and in fp16, one kernel launch each
    way, against the CPU port."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import load_reference_state
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn import MultiHeadAttention
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.transformer import (attention_paths_taken,
                                                 reset_attention_path_log)
    for embed, heads, dropout in ((256, 8, 0.0), (256, 8, 0.1)):
        (out, grads), (out_c, grads_c), log = route_mha(
            device, embed, heads, dropout, 40 + embed + heads)
        what = (f"MultiHeadAttention({embed}, {heads}) head dim "
                f"{embed // heads} dropout {dropout:g}")
        if log != ["composed"]:
            fail(f"routes: {what}: path log {log}, want ['composed']")
        # the key bias's gradient is 0 in exact arithmetic (it shifts a
        # row's scores by one constant): both sides hold rounding noise
        errs = {"out": close_to(out, out_c, ROUTE_TOL)}
        errs.update({n: close_to(g, grads_c[n], ROUTE_TOL)
                     for n, g in grads.items() if n != "k_proj.bias"})
        bad = [n for n, (_, ok) in errs.items() if not ok]
        if bad:
            fail(f"routes: {what}: {bad} beyond {ROUTE_TOL:g} of the CPU "
                 f"port: {[errs[n][0] for n in bad]}")
        say("routes", f"{what}: path log ['composed'] (CPU port "
            f"['reference']); output and {len(errs) - 1} gradients against "
            f"the CPU port, max error {max(e for e, _ in errs.values()):.3e}"
            f" (tol {ROUTE_TOL:g} of each tensor's largest + {ROUTE_TOL:g}"
            "|ref|); ok")

    # head dim 256: the flash route, refused
    mha = MultiHeadAttention(512, 2, device=device)
    x = torch.randn(2, 96, 512, device=device)
    refused("MultiHeadAttention(512, 2) head dim 256", lambda: mha(x))
    del mha

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
                 (4096, 768, torch.float16), (1024, 8192, torch.float32))


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
        "CTA, 2 stages")
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
    """Wrap opt.step to hand the gradients it is about to apply to sink."""
    inner = opt.step

    def step():
        sink(opt.named_parameters())
        inner()
    opt.step = step


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
    out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / reps


# (rows, F, x dtype) timed: the train step's norm in each dtype, and a
# wide row
LN_BWD_TIME_CASES = ((16384, 768, torch.float32),
                     (16384, 768, torch.bfloat16),
                     (16384, 768, torch.float16),
                     (2048, 8192, torch.float32))


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
                  (8, 12, 512, 64, False, torch.float32, 1.0))


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


def time_train_step(step, batch, cfg, card, reps=10):
    """The main path's step: eager ms (host clock, synchronised, median),
    tokens/s, MFU at 989 TFLOP/s with bench.py's FLOP count, and from
    torch.profiler the device busy time by kernel group and the idle
    share 1 - busy / eager."""
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*batch)
        torch.cuda.synchronize()
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
    busy = sum(groups.values())
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
# phase 6: generation
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


def serve_generation(engine, reqs, label):
    """The main path: ``reqs`` through a GenerationPool over ``engine``.
    Launch counts, the path log and the monitor are set to 0 just before
    and read just after. Returns (streams, record)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.generation import GenerationPool
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.kernels import paged_attention as PA
    torch.cuda.synchronize()
    PA.launches = PA.launches_quant = LN.launches = 0
    PA.reset_path_log()
    monitor.reset_all()
    t0 = time.perf_counter()
    with GenerationPool(engine) as pool:
        futs = [pool.submit(r) for r in reqs]
        results = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(counts=gen_counts(), paths=PA.paths_taken(), wall=wall,
               steps=int(monitor.timer_get(
                   "TIMER_generation_mixed_step_us")["count"]),
               step_us=monitor.timer_get("TIMER_generation_mixed_step_us"),
               ttft_us=monitor.timer_get("TIMER_generation_ttft_us"),
               tpot_us=monitor.timer_get("TIMER_generation_tpot_us"),
               stats={k: monitor.stat_get(f"STAT_generation_{k}") for k in
                      ("tokens", "prefills", "prefix_hits",
                       "prefix_hit_tokens", "prefix_cow_copies",
                       "evictions", "pad_tokens")})
    streams = {r.request_id: r.tokens for r in results}
    say("generate", f"{label}: {len(reqs)} requests through GenerationPool "
        f"in {wall:.2f} s, {rec['steps']} mixed steps; " + ", ".join(
            f"{k} {v:g}" for k, v in rec["stats"].items()))
    return streams, rec


def check_gen_launches(rec, cfg, kv, label):
    """Paged-kernel launches = layers x mixed steps (the kernel of the
    pool's dtype, none of the other), layer-norm launches = (2 layers + 1)
    x steps, an all-"cuda" path log of one entry a launch."""
    c, steps = rec["counts"], rec["steps"]
    which, other = ("paged", "paged_quant") if kv == "fp32" else \
        ("paged_quant", "paged")
    want = cfg.layers * steps
    if steps == 0 or c[which] != want or c[other] != 0:
        fail(f"{label}: paged launches {c} after {steps} mixed steps, want "
             f"{which} = {want}")
    if c["layer_norm"] != (2 * cfg.layers + 1) * steps:
        fail(f"{label}: layer_norm launches {c['layer_norm']}, want "
             f"{2 * cfg.layers + 1} x {steps}")
    if set(rec["paths"]) != {"cuda"} or len(rec["paths"]) != want:
        fail(f"{label}: paged path log {sorted(set(rec['paths']))} x "
             f"{len(rec['paths'])}, want 'cuda' x {want}")
    say("generate", f"{label}: {c[which]} {which} launches = {cfg.layers} "
        f"x {steps} mixed steps, {c['layer_norm']} layer_norm launches = "
        f"{2 * cfg.layers + 1} x {steps}, path log {len(rec['paths'])} x "
        "'cuda'")


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


def check_recompute(cfg, params, device, kv, reqs):
    """Paged against full recompute on the card: ``reqs`` through a
    fresh engine (prefix cache off, so a table's first block names its
    request), every sampled slot's logits against forward_full over the
    same context. fp32 pools: within GEN_TOL, and every greedy token the
    recompute's argmax or within 1e-3 of its maximum. int8 pools: within
    the reference's int8 budget against the fp32 recompute."""
    from paddle_tpu_torch.generation import GenerationEngine, forward_full
    eng = GenerationEngine(cfg, params, kv_dtype=kv, device=device,
                           **dict(GEN_GEO, prefix_cache=False))
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
        say("generate", f"paged vs full recompute, fp32 KV, {len(records)} "
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


def check_step_vs_cpu(cfg, params_np, device, kv="fp32", num_blocks=256):
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
    printed)."""
    import paddle_tpu_torch.generation.model as M
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.jit import load_reference_params
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
    card_rows, own_rows = [], []

    def on_card(x, dtype):
        q, sc = real_q(x, dtype)
        card_rows.append((q.cpu(), sc.cpu()))
        return q, sc

    def on_cpu(x, dtype):
        own_rows.append(real_q(x, dtype))
        return card_rows[len(own_rows) - 1]
    out = []
    try:
        for where, hook in ((device, on_card),
                            (torch.device("cpu"), on_cpu)):
            M.quantize_kv_rows = hook
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
    say("generate", f"one mixed step of {len(written)} slots at full width, "
        f"{kv} KV, card (kernels) vs CPU port (plain versions): " +
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
        f"tokens/s; mixed step p50 {us['step_us']['p50'] / 1e3:.2f} ms, p95 "
        f"{us['step_us']['p95'] / 1e3:.2f} ms ({rec['steps']} steps); TTFT "
        f"p50 {us['ttft_us']['p50'] / 1e3:.1f} ms, p95 "
        f"{us['ttft_us']['p95'] / 1e3:.1f} ms; TPOT p50 "
        f"{us['tpot_us']['p50'] / 1e3:.2f} ms, p95 "
        f"{us['tpot_us']['p95'] / 1e3:.2f} ms  [{card}]")


def run_generation(device, card, cfg_kw=GEN_CFG, n_requests=GEN_REQUESTS,
                   check_reqs=4):
    """Phase 6: the generation engine's main path at full width, its
    checks and its times. Returns (paged parity errors, the main path's
    records, paged kernel times)."""
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
    del params
    torch.cuda.empty_cache()
    paged_times = time_paged(device, card)
    for kv in ("fp32", "int8"):
        gen_times(recs[kv], f"{kv} KV", card)
    return paged_err, recs, paged_times


# ---------------------------------------------------------------------------

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

    # -- 6. generation: counts set to 0 just before each pool run, read
    # just after
    paged_err, gen_recs, paged_times = run_generation(device, card)

    # -- 7. records: launches are the serving, training and generation
    # runs
    ln_rec = ln_times[(4096, 768, torch.float32)]
    fa_key = (8, 12, 512, 512, 64, True, False, torch.bfloat16)
    fa_rec = fa_times[fa_key]
    bwd_key = (TRAIN_B, 12, TRAIN_S, 64, False, torch.bfloat16, 1.0)
    kernels = [
        dict(name="layer_norm_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/layer_norm.cu",
             replaces="paddle_tpu/kernels/layer_norm.py:33",
             launches=ln_total + train_counts["layer_norm_fwd"] + sum(
                 r["counts"]["layer_norm"] for r in gen_recs.values()),
             max_abs_err=ln_err[(4096, 768, torch.float32, 1e-12)],
             **ln_rec),
        dict(name="layer_norm_bwd", route="cuda",
             source="paddle_tpu_torch/csrc/layer_norm.cu",
             replaces="paddle_tpu/kernels/layer_norm.py:46",
             launches=train_counts["layer_norm_bwd"],
             max_abs_err=ln_bwd_err[(16384, 768, torch.float32)],
             **ln_bwd_times[(16384, 768, torch.float32)]),
        dict(name="flash_attention_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:207",
             launches=fa_total + train_counts["flash_attention_fwd"],
             max_abs_err=fa_err[(*fa_key, "contiguous")], **fa_rec),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:364",
             launches=train_counts["flash_attention_bwd_dq"],
             max_abs_err=fa_bwd_err[(0, "dq")],
             **fa_bwd_times[(*bwd_key, "dq")]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:413",
             launches=train_counts["flash_attention_bwd_dkv"],
             max_abs_err=max(fa_bwd_err[(0, "dk")], fa_bwd_err[(0, "dv")]),
             **fa_bwd_times[(*bwd_key, "dkv")]),
        dict(name="paged_attention", route="cuda",
             source="paddle_tpu_torch/csrc/paged_attention.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:215",
             launches=gen_recs["fp32"]["counts"]["paged"],
             max_abs_err=max(paged_err["fp32"],
                             paged_times["fp32"]["max_abs_err"]), **{
                 k: paged_times["fp32"][k] for k in KERNEL_TIME_KEYS}),
        dict(name="paged_attention_quant", route="cuda",
             source="paddle_tpu_torch/csrc/paged_attention.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:274",
             launches=gen_recs["int8"]["counts"]["paged_quant"],
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
