"""The port's side of ``serving_ops.py``: the custom ops registered with
the package's kernel libraries and its wrappers as the launchers.

Under ``torch.export`` (``torch.compiler.is_exporting()``) the wrappers
``layer_norm.layer_norm_fwd`` and ``flash_attention.flash_attention_fwd``
call ``op(name)`` instead of their ctypes launch, so that an exported
forward holds ``paddle_tpu::layer_norm_fwd`` and
``paddle_tpu::flash_attention_fwd`` nodes. A traced op on a CUDA tensor
runs the wrapper's ``_launch``/``_launch_fwd``, which moves the wrapper's
launch counter as an eager call does; on a CPU tensor it runs the plain
version. The eager path calls the wrappers directly: an op adds
PyTorch's dispatch to each launch (``chip_smoke.py`` times it).
"""
from __future__ import annotations

from . import _build, serving_ops

# the kernel libraries an exported serving forward launches from
SERVING_LIBRARIES = ("layer_norm", "flash_attention")


def _ln_launch(x, gamma, beta, eps):
    from . import layer_norm
    return layer_norm._launch(x, gamma, beta, eps)


def _fa_launch(q, k, v, bias, causal, sm_scale):
    from . import flash_attention
    return flash_attention._launch_fwd(q, k, v, bias, causal, sm_scale,
                                       None, None, 1.0)


def register():
    """Register the ops (once a process) with the package's libraries and
    wrappers; returns the owning ``serving_ops`` module."""
    return serving_ops.register(
        libraries={n: str(_build.library_path(n)) for n in SERVING_LIBRARIES},
        launchers={"layer_norm_fwd": _ln_launch,
                   "flash_attention_fwd": _fa_launch})


def op(name: str):
    """``torch.ops.paddle_tpu.<name>`` with the package's launchers."""
    register()
    return serving_ops.op(name)
