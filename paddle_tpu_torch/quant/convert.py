"""Checkpoint conversion CLI.

    python -m paddle_tpu_torch.quant.convert --in ckpt.npz --out q.npz \
        --mode int8

Counterpart of ``paddle_tpu/quant/convert.py``. Converts a flat fp32
decoder checkpoint (``generation/model.py``'s layout, an npz of name ->
array) to the quantized serving layout: per-channel int8 (or fp8-e4m3)
weights beside ``<name>::scale`` fp32 absmax arrays, saved with the mode,
so ``GenerationEngine(cfg, params, quant_mode=...)`` and
``load_quantized()`` of either package agree. ``--demo`` converts a freshly
initialised demo decoder (``DecoderConfig()``, seed 0) instead of
``--in``; ``--from-qat`` reads a contrib/slim export (``<name>.quant_scale``
naming) and carries its scales over verbatim.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from . import (from_qat, load_quantized, quantize_decoder_params,
               save_quantized, supports_fp8, weight_bytes_saved)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="convert an fp32 checkpoint to the quantized serving "
                    "layout")
    p.add_argument("--in", dest="inp", default=None,
                   help="input npz checkpoint (name -> fp32 array)")
    p.add_argument("--out", required=True, help="output npz path")
    p.add_argument("--mode", default="int8", choices=("int8", "fp8"))
    p.add_argument("--from-qat", action="store_true",
                   help="input uses contrib/slim '<name>.quant_scale' "
                        "naming; adapt scales verbatim (lossless)")
    p.add_argument("--demo", action="store_true",
                   help="ignore --in; convert a freshly initialized demo "
                        "decoder (DecoderConfig defaults)")
    ns = p.parse_args(argv)

    if ns.mode == "fp8" and not supports_fp8():
        print("fp8-e4m3 unsupported by this torch build; use --mode int8",
              file=sys.stderr)
        return 2

    if ns.demo:
        from ..generation.model import DecoderConfig, init_params
        params = init_params(DecoderConfig(), seed=0)
    elif ns.inp:
        data = np.load(ns.inp, allow_pickle=False)
        params = {k: data[k] for k in data.files if k != "__quant_mode__"}
    else:
        p.error("--in or --demo is required")

    q = from_qat(params, ns.mode) if ns.from_qat else \
        quantize_decoder_params(params, ns.mode)
    save_quantized(ns.out, q, ns.mode)
    back, mode = load_quantized(ns.out)
    if mode != ns.mode or len(back) != len(q):
        raise RuntimeError(f"{ns.out}: read back {len(back)} arrays in mode "
                           f"{mode!r}, wrote {len(q)} in {ns.mode!r}")
    print(f"wrote {ns.out}: {len(q)} arrays, mode={mode}, weight bytes "
          f"saved={weight_bytes_saved(q)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
