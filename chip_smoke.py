#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero:

1. setup: the card's name and power limit, TF32 off, the CUDA kernels
   built from ``paddle_tpu_torch/csrc`` with nvcc for sm_90a;
2. kernel parity: each CUDA kernel against its plain PyTorch version on
   the card, at BERT-base shapes, with stated tolerances;
3. serving, the main path: BERT-base at full width (``BertConfig()``),
   weights from a numpy seed carried in by ``load_reference_state``,
   answers requests in eval mode in fp32 and under bf16 ``auto_cast``.
   Launch counts are set to 0 before and read after; every forward must
   launch the flash kernel 12 times and the layer-norm kernel 26 times,
   and the attention path log must read "flash" only. The fp32 logits are
   held against the same model on the CPU (plain versions), and the bf16
   MLM argmax against fp32;
4. times, printed only: each kernel against its bound, its plain version
   and the one PyTorch call that computes the same function; the
   end-to-end forward per request shape, with its device time from a CUDA
   graph and a torch.profiler breakdown of device time by kernel group;
5. training, the second main path:
   (i) kernel parity of the layer-norm backward, the flash dQ and dK/dV
   kernels and the forward's dropout (explicit keep mask and in-kernel
   Philox, whose pattern is held bit for bit against
   ``philox_keep_mask``, with its drop rate; each kernel in seed mode is
   bitwise equal to itself in mask mode with ``philox_keep_mask``, and
   the tolerances are shown to fail two wrong dropouts);
   (ii) one fp32 ``TrainStep`` with Adam on the card against the CPU
   port: loss, every gradient, every parameter after the update;
   (iii) the main path: BERT-base at full width with dropout on, B=32,
   S=512, 80 masked positions, ``Adam(1e-4)``, bf16 ``auto_cast``, 10
   steps on one batch (the JAX package's bench.py configuration), counts
   set to 0 before and read after: 26 layer-norm forward and backward,
   12 flash forward, dQ and dK/dV launches a step, an all-"flash" path
   log, finite gradients for every parameter, a falling loss; a rerun
   from the same seed draws the same dropout; one fp32 step at B=8 S=512
   with the padding mask;
   (iv) times: each new kernel against its bound, its plain version and
   the library call; the train step's eager ms, tokens/s, MFU and device
   idle share, with a profiler breakdown;
6. one JSON line of kernel records, the card line, and last the result
   line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks at a 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores, dense
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
LN_TOL = {torch.float32: dict(y=(2e-5, 2e-5), mean=(1e-5, 1e-5),
                              rstd=(0.0, 1e-5)),
          torch.bfloat16: dict(y=(2.0 ** -9, 2.0 ** -6), mean=(1e-5, 1e-5),
                               rstd=(0.0, 1e-5))}
FLASH_TOL = {torch.float32: dict(o=(1e-5, 1e-5), lse=(1e-5, 1e-5)),
             torch.bfloat16: dict(o=(2.0 ** -9, 2.0 ** -6),
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
    import re
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            short = re.search(r"\d+([a-z][a-z_]*_kernel)(?:I(.*?)EEv)?",
                              mangled)
            kernel = mangled
            if short:
                args = [{"f": "f32", "14__nv_bfloat16": "bf16"}.get(
                    a.group(0), a.group(1)) for a in re.finditer(
                        r"14__nv_bfloat16|Li(\d+)E|f", short.group(2) or "")]
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
# and bf16 gamma/beta
LN_EDGE_CASES = ((7, 130, torch.float32, False), (7, 130, torch.bfloat16, False),
                 (5, 4096, torch.bfloat16, True), (3, 2050, torch.float32, False))


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
                                   dgamma=(1e-3, 1e-5), dbeta=(1e-3, 1e-5))}
# Flash backward (and the forward's o with dropout), (A, R): an element
# passes when |got - want| <= A + R |want|, with A taken as a fraction of
# the output's max |ref| in bf16. fp32: the same fp32 arithmetic in
# another order; dk and dv sum over 512 queries and dq over 512 keys,
# gradients of size ~1, so a few 1e-6. bf16: the kernels round p and ds to
# bf16 (2^-8 relative) before the tensor-core products and round the
# results to bf16; the plain version rounds once, at the end. The limit
# lies between what the sound kernels need and what a wrong dropout (the
# keep pattern of the neighbouring key, or 1/keep_prob left out) needs,
# both read by this script (check_flash_bwd; readings in PERF.md).
FLASH_BWD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -8,
                                                               2.0 ** -6)}
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
)
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
            if dtype == torch.bfloat16 else 1.0
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
        dq, dk, dv = FA._launch_bwd(do, q, k, v, o, lse, bias, causal, scale,
                                    keep, seed_t, kp)
        torch.cuda.synchronize()
        plain_keep = keep if drop != "seed" else FA.philox_keep_mask(
            seed, b, h, sq, sk, kp, device=device)
        label = (f"flash bwd [{b},{h},{sq},{d}] sk={sk} {dtype} bias="
                 f"{bias_kind} causal={causal} {layout} dropout={drop}")
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

def time_layer_norm(device, card, rows=4096, f=768, eps=1e-12):
    from paddle_tpu_torch.kernels import layer_norm as LN
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
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
        records[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bms, bound_by=by)
        say("times", f"layer_norm [{rows}x{f}] {dtype}: kernel {ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), plain {plain_ms:.4f} ms, "
            f"F.layer_norm {lib_ms:.4f} ms  [{card}]")
    return records


def time_flash(device, card):
    from paddle_tpu_torch.kernels import flash_attention as FA
    records = {}
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
            lib_ms = None
            if not causal:
                masks = [None if s[3] is None else s[3] > -1.0
                         for s in sets]
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
            lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            say("times", f"flash [{b},{h},{sq},{d}] sk={sk} {dtype} "
                f"bias={'[B,1,1,S]' if with_bias else 'none'} "
                f"causal={causal}: kernel {ms:.4f} ms, bound {bms:.4f} ms "
                f"({by}), plain {plain_ms:.4f} ms, SDPA {lib_txt}  [{card}]")
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
                 ("flash_attention_bwd_dkv", "FA", "launches_dkv"))


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
    (losses, counts, paths, recorder, model)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.jit import TrainStep, load_reference_state
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretraining_loss)
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
        losses = [float(step(*batch)) for _ in range(steps)]
        torch.cuda.synchronize()
        counts = read_counts()
        paths = attention_paths_taken()
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
    losses, counts, paths, rec, keep = train_run(device, state, batch,
                                                 TRAIN_STEPS, record=True)
    say("train", f"main path: BERT-base dropout 0.1/0.1, B={TRAIN_B} "
        f"S={TRAIN_S} M={TRAIN_M}, Adam({TRAIN_LR:g}), bf16 auto_cast, "
        f"{TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"main path: losses not finite or not lower at the end: "
             f"{losses}")
    n_ln = 2 * cfg.num_hidden_layers + 2
    per_step = {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
                "flash_attention_fwd": cfg.num_hidden_layers,
                "flash_attention_bwd_dq": cfg.num_hidden_layers,
                "flash_attention_bwd_dkv": cfg.num_hidden_layers}
    for name, n in per_step.items():
        if counts[name] != n * TRAIN_STEPS:
            fail(f"main path: {name} launched {counts[name]} times in "
                 f"{TRAIN_STEPS} steps, want {n} a step")
    if set(paths) != {"flash"} or \
            len(paths) != cfg.num_hidden_layers * TRAIN_STEPS:
        fail(f"main path: attention path log is not all 'flash': "
             f"{sorted(set(paths))} x {len(paths)}")
    say("train", "main path launches in "
        f"{TRAIN_STEPS} steps: " + ", ".join(f"{k} {v}" for k, v in
                                             counts.items()) +
        f" ({', '.join(f'{v} a step' for v in per_step.values())}); path "
        f"log {len(paths)} x 'flash'; every parameter's gradient present "
        "and finite at every step")
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


def time_layer_norm_bwd(device, card, rows=16384, f=768):
    from paddle_tpu_torch.kernels import layer_norm as LN
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
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
        records[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bms, bound_by=by)
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


TIME_BWD_CASES = ((32, 12, 512, 64, False, torch.bfloat16),
                  (32, 12, 512, 64, True, torch.bfloat16),
                  (8, 12, 512, 64, False, torch.float32))


def time_flash_bwd(device, card):
    """The dQ and the dK/dV kernels each alone (the dK/dV kernel reads the
    delta a dQ launch wrote before), the plain backward, and SDPA's
    backward (one autograd call for dq, dk and dv: the library's time for
    both rows, its kernels' time from the profiler). Also the forward with
    seed-mode dropout against without, the plain pattern
    (philox_keep_mask) and SDPA's forward with dropout."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as FA
    records = {}
    for b, h, s, d, with_bias, dtype in TIME_BWD_CASES:
        q, k, v, do = attn_grad_inputs(b, h, s, s, d, dtype, device,
                                       "contiguous", 500)
        bias = padding_bias(b, s, device, 501) if with_bias else None
        scale = 1.0 / math.sqrt(d)
        o, lse = FA._launch_fwd(q, k, v, bias, False, scale, None, None, 1.0)
        args, _, held = FA.bwd_args(do, q, k, v, o, lse, bias, False, scale,
                                    None, None, 1.0)
        fns = {w: FA.bwd_kernel(w) for w in ("dq", "dkv")}
        fns["dq"](*args, _build.stream_ptr(device))
        ms = {w: device_ms([lambda f=f: f(*args, _build.stream_ptr(device))])
              for w, f in fns.items()}
        plain_ms = device_ms([lambda: FA.attention_backward_reference(
            do, q, k, v, o, lse, bias, False, scale)], reps=3)
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        mask = None if bias is None else bias > -1.0
        out = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, scale=scale)
        lib_ms = profiled_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True))
        for w in ("dq", "dkv"):
            nbytes, flops = bwd_work(q, k, bias, w)
            bms, by = bound_ms(nbytes, flops, dtype)
            records[(b, h, s, d, with_bias, dtype, w)] = dict(
                ms=ms[w], plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by)
            say("times", f"flash_bwd_{w} [{b},{h},{s},{d}] {dtype} bias="
                f"{'[B,1,1,S]' if with_bias else 'none'}: kernel "
                f"{ms[w]:.4f} ms, bound {bms:.4f} ms ({by}), plain backward "
                f"{plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms  [{card}]")
        del held, out, ql, kl, vl

    # dropout: the forward with and without the in-kernel pattern
    b, h, s, d = TRAIN_B, 12, TRAIN_S, 64
    q, k, v = attn_inputs(b, h, s, s, d, torch.bfloat16, device, 510)
    seed_t = FA.seed_tensor(77, device)
    scale = 1.0 / math.sqrt(d)
    fwd_ms = device_ms([lambda: FA._launch_fwd(q, k, v, None, False, scale,
                                               None, None, 1.0)])
    drop_ms = device_ms([lambda: FA._launch_fwd(q, k, v, None, False, scale,
                                                None, seed_t, KEEP_PROB)])
    plain_ms = device_ms([lambda: FA.philox_keep_mask(77, b, h, s, s,
                                                      KEEP_PROB, device)],
                         reps=2)
    lib_ms = profiled_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                                       scale=scale))
    nbytes, flops = attn_work(q, k, None, False)
    bms, by = bound_ms(nbytes, flops, torch.bfloat16)
    records["dropout"] = dict(ms=drop_ms, no_dropout_ms=fwd_ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bms, bound_by=by)
    say("times", f"flash forward [{b},{h},{s},{d}] bf16 with seed-mode "
        f"dropout {drop_ms:.4f} ms, without {fwd_ms:.4f} ms (dropout "
        f"{drop_ms - fwd_ms:+.4f} ms), bound {bms:.4f} ms ({by}); plain "
        f"pattern philox_keep_mask {plain_ms:.4f} ms; SDPA forward with "
        f"dropout_p=0.1 {lib_ms:.4f} ms  [{card}]")
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
    reset_attention_path_log()
    outputs, per_forward = serve(model, requests)
    ln_total, fa_total = LN.launches, FA.launches
    paths = attention_paths_taken()

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
    say("serve", f"{n_fwd} forwards: layer_norm launches {ln_total}, flash "
        f"launches {fa_total}, path log {len(paths)} x 'flash'")
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

    # -- 6. records: launches are the serving run's plus the training run's
    ln_rec = ln_times[torch.float32]
    fa_key = (8, 12, 512, 512, 64, True, False, torch.bfloat16)
    fa_rec = fa_times[fa_key]
    bwd_key = (TRAIN_B, 12, TRAIN_S, 64, False, torch.bfloat16)
    kernels = [
        dict(name="layer_norm_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/layer_norm.cu",
             replaces="paddle_tpu/kernels/layer_norm.py:33",
             launches=ln_total + train_counts["layer_norm_fwd"],
             max_abs_err=ln_err[(4096, 768, torch.float32, 1e-12)],
             **ln_rec),
        dict(name="layer_norm_bwd", route="cuda",
             source="paddle_tpu_torch/csrc/layer_norm.cu",
             replaces="paddle_tpu/kernels/layer_norm.py:46",
             launches=train_counts["layer_norm_bwd"],
             max_abs_err=ln_bwd_err[(16384, 768, torch.float32)],
             **ln_bwd_times[torch.float32]),
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
