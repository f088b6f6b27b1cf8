"""Measures the port's layer-norm backward (paddle_tpu_torch/csrc/layer_norm.cu)
on the card. Each checkout DIR is timed in a process of its own, with the
kernels DIR builds from its own sources.

  python3 scripts/ln_bwd_probe.py times DIR [DIR ...]
      chip_smoke.time_layer_norm_bwd of each DIR in the order given; to
      compare two commits on one card, give them in turns (parent tree
      tree parent).
  python3 scripts/ln_bwd_probe.py sweep DIR
      device ms at F = 768 over 4096-65536 rows in fp32 and bf16, and at
      [2048, 8192]: the slope is the row loop's rate, the intercept what a
      call costs beyond it.
  python3 scripts/ln_bwd_probe.py trace DIR
      the timeline of one call at [16384, 768] (fp32, bf16) and
      [4096, 768] fp32 from %globaltimer stamps: a copy of DIR's package
      under DIR/paddle_tpu_torch/_build/ln_trace/ whose warp kernel stamps
      each warp's loop end and epilogue end, and whose reduce kernel
      stamps each CTA's start, wait end and end.

It needs a CUDA card and imports no JAX.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

TRACE_WORDS = 1 << 16
REDUCE_BASE = 60000  # reduce CTAs' stamps, 3 each, after the warps' 4 each

# (anchor in csrc/layer_norm.cu, text put after it)
TRACE_PATCH = (
    ("// Programmatic dependent launch:",
     None),  # the stamp helpers go before this line
    ("  load_gamma(gamma, sg, 0, F, F4, 32 * kWarps);\n",
     "  const int gw_ = blockIdx.x * kWarps + threadIdx.x / 32;\n"
     "  if (threadIdx.x % 32 == 0) g_trace[gw_ * 4] = gtime();\n"),
    ("    for (int d = 0; d < kDepth; ++d) buf[d] = buf[d + 1];\n  }\n",
     "  if (lane == 0) g_trace[gw_ * 4 + 1] = gtime();\n"),
    ("            which * F] = v;\n  }\n",
     "  if (lane == 0) g_trace[gw_ * 4 + 2] = gtime();\n"),
    ("  __shared__ float4 sums[kRedSlices][kRedQuads];\n",
     "  const int rb_ = %d + (blockIdx.y * gridDim.x + blockIdx.x) * 3;\n"
     "  if (threadIdx.x == 0) g_trace[rb_] = gtime();\n" % REDUCE_BASE),
    ("  wait_prerequisites();\n",
     "  if (threadIdx.x == 0) g_trace[rb_ + 1] = gtime();\n"),
    ("      if (j < n) store_one(dst + j, out[j]);\n  }\n",
     "  if (threadIdx.x == 0) g_trace[rb_ + 2] = gtime();\n"),
)
TRACE_HELPERS = """__device__ unsigned long long g_trace[%d];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
""" % TRACE_WORDS
TRACE_READER = """
extern "C" int pt_ln_trace(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, n * 8));
}
"""


def child(cmd, root):
    return subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           cmd, str(root)], cwd=root).returncode


def _setup(root):
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as C
    from paddle_tpu_torch.kernels import _build
    _build.build(["layer_norm"])
    return torch, C, C.card_line(), torch.device("cuda", 0)


def run_times(root):
    torch, C, card, dev = _setup(root)
    print(f"---- {root}", flush=True)
    C.time_layer_norm_bwd(dev, card)


def run_sweep(root):
    torch, C, card, dev = _setup(root)
    from paddle_tpu_torch.kernels import layer_norm as LN
    cases = [(r, 768, dt) for dt in (torch.float32, torch.bfloat16)
             for r in (4096, 8192, 16384, 32768, 65536)]
    cases.append((2048, 8192, torch.float32))
    for rows, f, dt in cases:
        size = 4 if dt == torch.float32 else 2
        sets = C.copies(lambda i: C.ln_bwd_case(rows, f, dt, False, dev,
                                                400 + i), 3 * rows * f * size)
        ms = C.device_ms([lambda s=s: LN._launch_bwd(*s) for s in sets])
        nbytes = 3 * rows * f * size + 8 * rows + 12 * f
        print(f"[{rows}x{f}] {str(dt)[6:]}: {ms:.4f} ms, "
              f"{nbytes / ms / 1e9:.3f} TB/s  [{card}]", flush=True)


def make_trace_copy(root):
    """DIR/paddle_tpu_torch/_build/ln_trace: the package and chip_smoke.py
    with the stamps in its layer_norm.cu."""
    dst = root / "paddle_tpu_torch" / "_build" / "ln_trace"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
    cu = dst / "paddle_tpu_torch" / "csrc" / "layer_norm.cu"
    src = cu.read_text()
    for anchor, text in TRACE_PATCH:
        if src.count(anchor) != 1:
            raise SystemExit(f"ln_bwd_probe trace: anchor {anchor!r} is not "
                             "in csrc/layer_norm.cu exactly once")
        src = src.replace(anchor, TRACE_HELPERS + anchor if text is None
                          else anchor + text)
    cu.write_text(src + TRACE_READER)
    return dst


def run_trace(root):
    torch, C, card, dev = _setup(root)
    import numpy as np
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import layer_norm as LN
    read = _build.load("layer_norm").pt_ln_trace
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int

    def us(t):
        return t / 1e3
    for rows, f, dt in ((16384, 768, torch.float32),
                        (16384, 768, torch.bfloat16),
                        (4096, 768, torch.float32)):
        s = C.ln_bwd_case(rows, f, dt, False, dev, 400)
        groups = LN.bwd_grid(rows, f)[0]
        warps = LN.bwd_cta_warps(LN.bwd_instance(f)[1])
        for rep in range(3):
            buf = np.zeros(TRACE_WORDS, dtype=np.uint64)
            LN._launch_bwd(*s)
            LN._launch_bwd(*s)
            torch.cuda.synchronize()
            if read(buf.ctypes.data, TRACE_WORDS) != 0:
                raise SystemExit("ln_bwd_probe trace: reading stamps failed")
            w = buf[:groups * warps * 4].reshape(groups, warps, 4)
            w = w.astype(np.int64)
            nred = 2 * -(-f // 32)
            red = buf[REDUCE_BASE:REDUCE_BASE + 3 * nred].reshape(-1, 3)
            t0 = w[:, :, 0].min()
            loop_end = us(w[:, :, 1] - t0)
            epi = us(w[:, :, 2] - t0)
            per_cta = epi.max(1) - loop_end.max(1)
            rr = us(red.astype(np.int64) - t0)
            print(f"[{rows}x{f}] {str(dt)[6:]} call {rep}: warp loops end "
                  f"median {np.median(loop_end):.2f} us, last "
                  f"{loop_end.max():.2f}; a CTA's epilogue median "
                  f"{np.median(per_cta):.2f}, max {per_cta.max():.2f}; "
                  f"first kernel's last stamp {epi.max():.2f}; reduce CTAs "
                  f"start {rr[:, 0].min():.2f}-{rr[:, 0].max():.2f}, pass "
                  f"their wait {rr[:, 1].min():.2f}-{rr[:, 1].max():.2f}, "
                  f"end {rr[:, 2].max():.2f}  [{card}]", flush=True)


def main(argv):
    if len(argv) < 2:
        raise SystemExit(__doc__)
    cmd, dirs = argv[0], [Path(d).resolve() for d in argv[1:]]
    if cmd.startswith("_"):  # a child: one checkout, in its own process
        {"_times": run_times, "_sweep": run_sweep,
         "_trace": run_trace}[cmd](dirs[0])
        return 0
    if cmd == "trace":
        return child("_trace", make_trace_copy(dirs[0]))
    if cmd not in ("times", "sweep"):
        raise SystemExit(__doc__)
    return max(child("_" + cmd, d) for d in dirs)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
