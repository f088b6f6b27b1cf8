"""Checks, on the card, the artifact loader's build of the kernels: a
2-layer BERT encoder at ``BertConfig()``'s widths is exported by a
Predictor on the card, the artifact's shipped kernel libraries are
removed, and a process that cannot import ``paddle_tpu_torch``,
``paddle_tpu`` or ``jax`` serves it: ``SerializedCore`` builds both
libraries from the shipped sources with nvcc (both at once), and its
output is held against the Predictor's.

    python3 scripts/artifact_rebuild.py

Prints the build's seconds, the libraries built, the launches and the
largest difference from the Predictor; exits 1 when the serving process
fails or the difference passes 1e-3. It needs a CUDA card and nvcc.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402

SERVE = '''
import importlib.util, os, sys, time
for name in ("paddle_tpu_torch", "paddle_tpu", "jax"):
    sys.modules[name] = None
import numpy as np
art, feeds, out = sys.argv[1:4]
spec = importlib.util.spec_from_file_location("core", art + "/serving_core.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
t0 = time.perf_counter()
core = mod.SerializedCore(art)
print("built in %.1f s: %s" % (time.perf_counter() - t0,
                               sorted(os.listdir(art + "/kernels/build"))))
with np.load(feeds) as f:
    got = core.run([f["f%d" % i] for i in range(len(f.files))])
np.save(out, got[0])
print("launches", core.launches)
'''


def main() -> int:
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import inference as TI
    from paddle_tpu_torch.core.scope import load_reference_scope
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_kw = dict(C.INFER_CFG, layers_n=2)
    with tempfile.TemporaryDirectory() as root:
        main_prog, _, out = C.build_bert_encoder(pt, **cfg_kw)
        scope = pt.Scope()
        load_reference_scope(scope, C.bert_encoder_state(main_prog), "cpu")
        bundle = os.path.join(root, "bundle")
        pt.save_inference_model(bundle, list(C.INFER_FEEDS), [out],
                                pt.Executor("cpu"), main_program=main_prog,
                                scope=scope)
        cfg = TI.Config(bundle)
        cfg.enable_use_gpu()
        pred = TI.create_predictor(cfg)
        feed = C.bert_encoder_feed(4, cfg_kw, lo=16)
        want = pred.run(feed)[0]
        art = os.path.join(root, "art")
        pred.export_serialized(art, feed)
        kdir = os.path.join(art, "kernels")
        for f in os.listdir(kdir):
            if f.endswith(".so"):
                os.remove(os.path.join(kdir, f))
        feeds = os.path.join(root, "feed.npz")
        np.savez(feeds, **{f"f{i}": v for i, v in enumerate(feed)})
        script = os.path.join(root, "serve.py")
        with open(script, "w") as f:
            f.write(SERVE)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        got_path = os.path.join(root, "out.npy")
        proc = subprocess.run([sys.executable, script, art, feeds, got_path],
                              capture_output=True, text=True, env=env,
                              cwd=root)
        print(proc.stdout, proc.stderr[-3000:])
        if proc.returncode != 0:
            return 1
        err = float(np.abs(np.load(got_path) - want).max())
    print(f"max difference from the Predictor {err:g}  [{C.card_line()}]")
    return 0 if err <= 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
