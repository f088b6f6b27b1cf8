"""Measures ``torch._int_mm`` (cuBLASLt's int8 x int8 -> int32 product, the
card's half of ``paddle_tpu_torch.quant.qmatmul``) on the card: which row
counts it takes, whether it is exact, and its device time with the int8
weight row-major [K, N] against column-major (a [N, K] tensor's ``.t()``),
beside the fp32 ``torch.matmul``, at the generation decoder's shapes
(hidden 1024, vocab 32000) and 16, 17, 32 and 80 rows.

    python3 scripts/int_mm_layouts.py

Times are CUDA events around 50 calls after 5 warm ones. It needs a CUDA
card and imports no JAX.
"""
import subprocess
import sys

import torch

SHAPES = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
          (1024, 32000))


def event_ms(fn, reps=50):
    for _ in range(5):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("int_mm_layouts: needs a CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    for m in (16, 17, 32, 80):
        for k, n in SHAPES:
            a = torch.randint(-127, 128, (m, k), generator=g,
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (k, n), generator=g,
                              dtype=torch.int8)
            want = (a.double() @ b.double()).to(torch.int32)
            ad, bd = a.to(dev), b.to(dev)
            for name, bb in (("row-major", bd),
                             ("column-major", b.t().contiguous().to(dev).t())):
                try:
                    ok = torch.equal(torch._int_mm(ad, bb).cpu(), want)
                except RuntimeError as e:
                    print(f"M {m} K {k} N {n} {name}: refused: {e}")
                    continue
                ms = event_ms(lambda: torch._int_mm(ad, bb))
                print(f"M {m} K {k} N {n} {name}: exact {ok}, {ms:.4f} ms")
            x = torch.randn(m, k, generator=g).to(dev)
            w = torch.randn(k, n, generator=g).to(dev)
            print(f"M {m} K {k} N {n} fp32 torch.matmul "
                  f"{event_ms(lambda: x @ w):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
