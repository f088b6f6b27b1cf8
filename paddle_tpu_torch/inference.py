"""Inference API: ``Config``, ``Predictor`` and its shape buckets as CUDA
graphs.

Counterpart of ``paddle_tpu/inference.py`` (Paddle Inference's
``AnalysisConfig`` and ``AnalysisPredictor``). A ``Predictor`` loads an
inference bundle (``io.save_inference_model``, either package's), runs
the pass pipeline on it (``GpuPassStrategy``: eval-mode dropout removed,
BERT's embedding block onto the layer-norm kernel, attention onto the
flash kernels, the add + activation marker) and serves ``run`` through
the port's ``Executor``.

Shape buckets (``Config.switch_shape_bucketing``): the batch axis is
padded up to a ladder of sizes and the rows sliced back, with the JAX
package's counters (``STAT_predictor_bucket_hit``/``_cold``,
``_pad_rows``, ``_pad_elements``, ``_bucket_overflow``, ``_bucket_skip``).
Where the JAX package compiles one XLA executable per bucketed
signature, the port on the card captures one ``torch.cuda.CUDAGraph``:
the first run of a signature runs the program eagerly on the capture
stream (its answer is returned), then captures the executor's op loop
(``Executor._run_block``) over static feed buffers; later runs copy the
feeds into those buffers, replay the graph and copy the fetches out
(``STAT_predictor_graph_capture``, ``STAT_predictor_graph_replay``). The
graphs share one memory pool, and ``warmup_buckets`` captures from the
largest bucket down. Runs without a ladder, and batches past it, stay
eager, so the ladder bounds the number of graphs; on the CPU every run
is eager. A capture that fails raises, naming the op that broke it; it
never falls back to the eager path on the card. The kernels' launch
counters and path logs are Python-side: they count the capture, not a
replay. A program that holds a structural op reading its predicate on
the host (``while``, ``cond``, ``conditional_block``:
``host_control_flow``) is never captured, since a graph would replay the
branch of its capture: its buckets run eagerly on the card, each such run
counted in ``STAT_predictor_graph_refused`` and logged as "eager" in
``bucket_paths`` (a captured one as "graph").

Fetches are numpy arrays; a bf16 fetch (``enable_bf16``) is widened to
float32, which is exact (the JAX package returns ml_dtypes bfloat16
arrays). Device rule: the Predictor runs on the card (``cuda:<id>`` of
``enable_use_gpu``, else the default device) and raises without one
unless the config asks for the CPU (``disable_gpu()``).

Weight-only quantized serving (``Config.enable_quant("int8")``, or
``FLAGS_quant_mode``): at load, after the passes, every matmul-family
weight is stored int8 in the scope beside its ``<name>.quant_scale``
absmax, with slim's ``fake_channel_wise_dequantize_max_abs`` before its
consumers (``quant.quantize_program_weights``); the saving is
``GAUGE_quant_weight_bytes_saved``. It excludes bf16, and fp8 is refused
(flat decoder checkpoints only), as in the JAX package.

The serving artifact (``export_serialized``): ``torch.export`` (non-strict)
of the pass-pipelined ``Executor._run_block`` (``_Forward``) as a module
whose buffers are the persistables (``_Bound``), the kernels as the custom ops of
``kernels/serving_ops.py``, written with ``serving_core.py`` (the
framework-free ``SerializedCore``, which ``SerializedPredictor`` fronts and
the C ABI, ``capi.py``, embeds), the ops file and the kernels' sources
and libraries. A program that reads a value on the host cannot be traced:
the export raises naming the op.

The program cache (``Config.enable_program_cache``, ``core/program_cache.py``):
the Predictor's forward keyed by ``Program.fingerprint`` of the bundle's
program (with the pipeline, bf16 and the quant mode, the declared feed
signature and the device). The entry holds the graph without its
weights: the persistables are the exported forward's first argument, and
each process binds them from the bundle's parameter file, as the JAX
package's Predictor loads them before its cached executable runs. A hit
loads the ``.pt2`` and the parameters and skips the pass pipeline, the
quantization's program rewrite and the export (the bf16 cast and the int8
weights are made from the bundle's parameters as a cold start makes
them); a miss runs them, exports the forward with a dynamic batch,
stores it and runs the module it reads back, so a cold and a warm process
run the same graph. Either way every run (and every bucket's graph) goes
through that module. A program that cannot be exported is served as
without the cache (``STAT_program_cache_unexportable``).

Adaptive bucket dispatch (``Config.switch_autotune``, ``autotune.py``): for
each (rows, bucket) key the pad-to-bucket and the exact-shape forms are
timed in turns on the real request, and only a form whose rows are
bitwise those of the bucket form may win; the winner is kept in the
policy layer. On the card a padded bucket is a graph replay and the exact
shape an eager run, whose products cuBLAS may pick by shape: when the two
differ in a bit, "bucket" wins.

Not ported yet, raising ``NotImplementedError``: SPMD serving
(``enable_spmd``, ``ROADMAP.md`` A6). The ``serving/predict`` telemetry
span and its ``TIMER_predictor_run_us`` go with A7.
"""
from __future__ import annotations

import collections
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import device as _device
from . import io as _io
from .core.control_flow import HOST_PREDICATE_OPS
from .core.executor import Executor, _as_feed, as_numpy
from .core import program_cache
from .core.passes import apply_pass
from .core.program import Program
from .core.registry import LowerCtx
from .core.scope import Scope
from .flags import get_flag
from .monitor import gauge_set, stat_add

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))

__all__ = ["Config", "AnalysisConfig", "Predictor", "create_predictor",
           "PredictorTensor", "PassStrategy", "GpuPassStrategy",
           "TpuPassStrategy", "SerializedPredictor", "parse_bucket_ladder",
           "bucket_for", "bucket_or_exact"]


def parse_bucket_ladder(spec) -> List[int]:
    """A ladder from a spec: a list of sizes, a comma string ("1,2,4,8")
    or "pow2:N" (powers of two up to N); sorted, unique, positive. An
    empty spec or None is no ladder ([])."""
    if spec is None:
        return []
    if isinstance(spec, (list, tuple)):
        ladder = [int(x) for x in spec]
    else:
        s = str(spec).strip()
        if not s:
            return []
        if s.startswith("pow2:"):
            cap = int(s[len("pow2:"):])
            ladder, b = [], 1
            while b <= cap:
                ladder.append(b)
                b *= 2
        else:
            ladder = [int(x) for x in s.split(",") if x.strip()]
    return sorted({b for b in ladder if b > 0})


def bucket_for(n: int, ladder: Sequence[int]) -> Optional[int]:
    """The smallest bucket >= n, or None past the ladder."""
    for b in ladder:
        if b >= n:
            return b
    return None


def bucket_or_exact(n: int, ladder: Sequence[int],
                    overflow_stat: Optional[str] = None,
                    pad_stat: Optional[str] = None) -> int:
    """The pad target: the smallest bucket >= n, else n itself (counted
    in ``overflow_stat``); ``pad_stat`` counts the padding."""
    b = bucket_for(n, ladder)
    if b is not None:
        if pad_stat and b > n:
            stat_add(pad_stat, b - n)
        return b
    if overflow_stat:
        stat_add(overflow_stat)
    return n


class PassStrategy:
    """An ordered, editable pass pipeline (Paddle's ``PaddlePassBuilder``):
    names of ``core/passes.py`` passes, applied in order at load."""

    def __init__(self, passes: Optional[List[str]] = None):
        self._passes = list(passes or [])

    def append_pass(self, name: str):
        self._passes.append(name)

    def insert_pass(self, idx: int, name: str):
        self._passes.insert(idx, name)

    def delete_pass(self, name: str):
        self._passes = [p for p in self._passes if p != name]

    def passes(self) -> List[str]:
        return list(self._passes)


class GpuPassStrategy(PassStrategy):
    """The default pipeline (Paddle's name, ``paddle_pass_builder.cc``;
    the JAX package's ``TpuPassStrategy``): eval-mode dropout removed, the
    BERT embedding block and attention fused onto the port's layer-norm
    and flash kernels, and the add + activation marker."""

    def __init__(self):
        super().__init__(["drop_dropout_eval",
                          "embedding_eltwise_layernorm_fuse",
                          "multihead_matmul_fuse",
                          "fuse_elewise_add_act"])


# the JAX package's name for the same pipeline
TpuPassStrategy = GpuPassStrategy


class Config:
    """``AnalysisConfig``: the bundle's directory (or its program and
    parameter files), the device, the pass pipeline, bf16, weight
    quantization and the shape buckets."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        # None: the default device (the card, under device.py's rule)
        self._device: Optional[str] = None
        self._ir_optim = True
        self._bf16 = False
        self._pass_builder: Optional[PassStrategy] = None
        # None: no buckets; True: FLAGS_predictor_shape_buckets; a list
        # pins the ladder
        self._shape_buckets = None
        self._bucket_axes = (0,)
        # None: FLAGS_quant_mode; enable_quant()/disable_quant() pin it
        self._quant_mode: Optional[str] = None
        # None: FLAGS_program_cache_dir or PADDLE_TPU_PROGRAM_CACHE_DIR when
        # one names a directory, else no cache; "": no cache
        self._program_cache_dir: Optional[str] = None
        # None: FLAGS_autotune
        self._autotune: Optional[bool] = None

    # --- device ---------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on ``cuda:<device_id>``; the pool size is the caching
        allocator's business."""
        self._device = "gpu:%d" % int(device_id)

    def disable_gpu(self):
        """Run on the CPU."""
        self._device = "cpu"

    def device(self) -> torch.device:
        """The predictor's torch.device; raises when it names the card and
        there is none."""
        return _device.resolve(self._device)

    # --- the pipeline, bf16 and the buckets ------------------------------
    def switch_ir_optim(self, x: bool = True):
        self._ir_optim = x

    def enable_bf16(self):
        """Serve with every fp32 persistable cast to bf16 at load."""
        self._bf16 = True

    enable_mkldnn_bfloat16 = enable_bf16

    def pass_builder(self) -> PassStrategy:
        """The editable pipeline, ``GpuPassStrategy`` until changed."""
        if self._pass_builder is None:
            self._pass_builder = GpuPassStrategy()
        return self._pass_builder

    def switch_shape_bucketing(self, x: bool = True, buckets=None,
                               axes: Sequence[int] = (0,)):
        """Pad the batch axis (axis 0, sliced back) and optionally other
        axes (not sliced: the program masks them) up to the ladder:
        ``buckets`` pins it, default ``FLAGS_predictor_shape_buckets``."""
        if not x:
            self._shape_buckets = None
            return
        self._shape_buckets = True if buckets is None else \
            parse_bucket_ladder(buckets)
        self._bucket_axes = tuple(sorted(set(int(a) for a in axes)))
        if not self._bucket_axes or self._bucket_axes[0] != 0:
            raise ValueError("bucket axes must include axis 0 (batch)")

    def enable_shape_bucketing(self, buckets=None,
                               axes: Sequence[int] = (0,)):
        self.switch_shape_bucketing(True, buckets, axes)

    def disable_shape_bucketing(self):
        self.switch_shape_bucketing(False)

    # --- weight quantization --------------------------------------------
    def enable_quant(self, mode: str = "int8"):
        """Serve with weight-only int8 quantization (not bitwise against
        fp32: within the JAX package's error budget)."""
        if mode not in ("off", "int8"):
            raise ValueError(f"Predictor quant mode {mode!r} not supported "
                             "(off|int8; fp8 is flat-checkpoint only)")
        self._quant_mode = mode
        return self

    def disable_quant(self):
        self._quant_mode = "off"

    # --- the program cache and autotune --------------------------------
    def enable_program_cache(self, cache_dir: Optional[str] = None):
        """Warm-start the Predictor from the program cache at ``cache_dir``
        (default ``program_cache.default_dir()``); autotune's policy layer
        lives there too."""
        self._program_cache_dir = cache_dir or program_cache.default_dir()
        return self

    def disable_program_cache(self):
        self._program_cache_dir = ""

    def switch_autotune(self, x: bool = True):
        """Tune the bucket-or-exact choice a (rows, bucket) key, once,
        keeping the winner in the policy layer; default FLAGS_autotune."""
        self._autotune = bool(x)
        return self

    def cache_dir(self) -> Optional[str]:
        """The program cache directory in use, or None
        (``program_cache.resolve_dir``)."""
        return program_cache.resolve_dir(self._program_cache_dir)

    # --- not ported yet -------------------------------------------------
    def enable_spmd(self, plan_or_spec, data_axis: str = "dp"):
        raise NotImplementedError(
            "Config.enable_spmd: SPMD serving is not ported yet "
            "(ROADMAP.md A6)")

    def disable_spmd(self):
        pass


AnalysisConfig = Config


class PredictorTensor:
    """A named input or output handle (``ZeroCopyTensor``)."""

    def __init__(self, name: str, predictor: "Predictor", is_input: bool):
        self.name = name
        self._pred = predictor
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise ValueError(f"{self.name!r} is an output handle")
        self._pred._feeds[self.name] = np.asarray(arr)

    def reshape(self, shape):
        pass  # the shape comes from the array fed

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            raise ValueError(f"{self.name!r} is an input handle")
        return np.asarray(self._pred._outputs[self.name])


class _BucketGraph:
    """One captured signature: the graph, its static feed buffers by name
    and its fetch tensors in fetch order."""

    __slots__ = ("graph", "feeds", "fetches")

    def __init__(self, graph, feeds, fetches):
        self.graph = graph
        self.feeds = feeds
        self.fetches = fetches


class _Forward(torch.nn.Module):
    """A program's forward as a module for ``torch.export``:
    ``forward(params, feeds)`` runs ``Executor._run_block`` over the
    persistables by name and the feeds and returns the fetches in order.
    The program cache exports it as it is (a graph without weights);
    the serving artifact wraps it in ``_Bound``."""

    def __init__(self, exe: Executor, program: Program,
                 fetch_names: Sequence[str]):
        super().__init__()
        self._exe, self._program = exe, program
        self._fetch_names = list(fetch_names)

    def forward(self, params: Dict[str, torch.Tensor],
                feeds: Dict[str, torch.Tensor]):
        env = dict(params)
        env.update(feeds)
        # serving runs no random op: the pipeline drops eval dropout
        ctx = LowerCtx(self._exe.device, is_test=True,
                       generator=torch.Generator().manual_seed(0))
        self._exe._run_block(self._program, env, ctx)
        missing = [n for n in self._fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch {missing}: no op of the program produced "
                           "it and it is not fed")
        return tuple(env[n] for n in self._fetch_names)


class _Bound(torch.nn.Module):
    """``forward(feeds)`` of a forward that takes ``(params, feeds)``
    (``_Forward``, or the program cache's module), the persistables held
    as buffers: ``torch.export`` lifts them into the artifact's weights."""

    def __init__(self, inner, params: Dict[str, torch.Tensor]):
        super().__init__()
        self._inner = inner
        self._bound = []
        for name, val in params.items():
            buf = f"p{len(self._bound)}"
            self.register_buffer(buf, val)
            self._bound.append((name, buf))

    def forward(self, feeds: Dict[str, torch.Tensor]):
        return self._inner({n: getattr(self, buf) for n, buf in self._bound},
                           feeds)


def _kernel_ops(ep) -> Dict[str, int]:
    """The calls of each kernel op (``kernels/serving_ops.py``) in an
    exported program's graphs."""
    counts = collections.Counter()
    for mod in ep.graph_module.modules():
        if isinstance(mod, torch.fx.GraphModule):
            for node in mod.graph.nodes:
                target = str(node.target)
                if node.op == "call_function" and \
                        target.startswith("paddle_tpu."):
                    counts[target.split(".")[1]] += 1
    return dict(counts)


def _host_op(e: BaseException) -> Optional[str]:
    """The op that a lowering's note (``Executor._lower_one``) names."""
    for note in getattr(e, "__notes__", ()):
        if note.startswith("while lowering op"):
            return note
    return None


class Predictor:
    """A loaded, pass-optimized inference program: ``run(feeds)`` or the
    handles. Not thread-safe: ``serving.PredictorPool`` calls it from its
    one worker thread."""

    def __init__(self, config: Config, scope: Optional[Scope] = None):
        if config.model_dir is None:
            raise ValueError("Config.model_dir is required")
        self.config = config
        self.device = config.device()
        self.scope = scope if scope is not None else Scope()
        self.exe = Executor(self.device)
        # the exported forward every run goes through (the program cache)
        # and the persistables it takes, its fingerprint, and whether it
        # was read from the cache
        self._module = None
        self._params: Dict[str, torch.Tensor] = {}
        self._feed_dtypes: Dict[str, torch.dtype] = {}
        self.fingerprint: Optional[str] = None
        self.cache_hit = False
        self._feeds: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, np.ndarray] = {}
        # bucketed signatures already run: hits against cold first runs
        self._warm_sigs: set = set()
        self._graphs: Dict[tuple, _BucketGraph] = {}
        self._graph_pool = None
        self._capture_stream = None
        self.host_control_flow: List[str] = []
        # how each bucketed run went: "graph", or "eager" for a program
        # with host_control_flow (the last 65536, as the path logs keep)
        self.bucket_paths: "collections.deque[str]" = collections.deque(
            maxlen=65536)
        at = config._autotune
        self._autotune = bool(get_flag("FLAGS_autotune") if at is None
                              else at)
        qm = config._quant_mode if config._quant_mode is not None \
            else str(get_flag("FLAGS_quant_mode"))
        self.quant_mode = qm if qm in ("off", "int8") else "off"
        cache_dir = config.cache_dir()
        if cache_dir is not None and self._warm_start(cache_dir):
            return
        self._load_and_optimize()
        if cache_dir is not None and self.fingerprint is not None:
            self._cold_export(cache_dir)

    def _load_and_optimize(self):
        """The bundle into the scope, then the pass pipeline, the weight
        quantization and the bf16 cast."""
        config = self.config
        self.program, self.feed_names, self.fetch_names = \
            _io.load_inference_model(
                config.model_dir, self.exe, model_filename=config.prog_file,
                params_filename=config.params_file, scope=self.scope)
        if config._ir_optim:
            for name in config.pass_builder().passes():
                # fetch targets keep their producers through any fusion
                self.program = apply_pass(self.program, name,
                                          protected=set(self.fetch_names))
        if self.quant_mode != "off":
            if config._bf16:
                raise ValueError(
                    "enable_quant and bf16 are mutually exclusive: the bf16 "
                    "cast would truncate the fp32 quant scales")
            from .quant import quantize_program_weights
            gauge_set("GAUGE_quant_weight_bytes_saved",
                      quantize_program_weights(self.program, self.scope,
                                               self.quant_mode))
        if config._bf16:
            self._cast_params_bf16()
        # a structural op that reads its predicate on the host (while,
        # cond, conditional_block) cannot be captured: its branch would be
        # frozen at the capture's; such a program's buckets run eagerly
        self.host_control_flow = sorted({
            op.type for blk in self.program.blocks for op in blk.ops
            if op.type in HOST_PREDICATE_OPS})

    # --- the program cache ------------------------------------------------
    def _bundle_key(self):
        """(fingerprint, example feeds, the bundle's meta) of the bundle's
        program as this config serves it, from its JSON; no fingerprint
        when it cannot be keyed (an attr that does not canonicalize, a
        feed with an unknown non-batch dim). The parameters' values stay
        out of it: each process binds its own."""
        config = self.config
        with open(os.path.join(config.model_dir, config.prog_file or
                               _io.MODEL_FILE)) as f:
            meta = json.load(f)
        program = Program.from_dict(meta["program"])
        feeds = {}
        for n in meta["feed_names"]:
            v = program.global_block.vars.get(n)
            shape = list(v.shape) if v is not None and v.shape else []
            if any(d < 0 for d in shape[1:]):
                return None, None, meta
            shape = [2 if d < 0 else d for d in shape[:1]] + shape[1:]
            feeds[n] = np.zeros(shape, dtype=str(v.dtype))
        passes = tuple(config.pass_builder().passes()) \
            if config._ir_optim else ()
        fp = program.fingerprint(
            feed_sig=[(n, v.shape[1:], str(v.dtype)) for n, v in
                      feeds.items()],
            fetch_names=meta["fetch_names"],
            extra=(passes, config._bf16, self.quant_mode), device=self.device)
        return fp, feeds, meta

    def _warm_start(self, cache_dir: str) -> bool:
        """Serve from the cached module when the fingerprint hits, its
        persistables bound from the bundle's parameter file."""
        from .kernels import traced
        fp, self._cache_feeds, meta = self._bundle_key()
        self.fingerprint = fp
        if fp is None:
            stat_add("STAT_program_cache_unexportable")
            return False
        traced.register()
        hit = program_cache.load_program(cache_dir, fp)
        if hit is None:
            return False
        sig = json.loads(hit[1]["signature.json"])
        self._bind_bundle_params(sig["params"])
        self.program = None
        self.feed_names = list(meta["feed_names"])
        self.fetch_names = list(meta["fetch_names"])
        self._use_module(hit[0], sig)
        self.cache_hit = True
        return True

    def _bind_bundle_params(self, names: Sequence[str]) -> None:
        """The persistables ``names`` into the scope from the bundle's
        parameter file, as ``_load_and_optimize`` leaves them: int8 with
        its ``<name>.quant_scale`` for a weight whose scale is among them,
        bf16 for the other fp32 ones under bf16."""
        from .quant import SCALE_VAR_SUFFIX, quantize_weight_int8
        names = set(names)
        scales = {n for n in names if n.endswith(SCALE_VAR_SUFFIX) and
                  n[:-len(SCALE_VAR_SUFFIX)] in names}
        scaled = {n[:-len(SCALE_VAR_SUFFIX)] for n in scales}
        raw = sorted(names - scales)
        _io.load_vars(self.exe, self.config.model_dir, vars=raw,
                      filename=self.config.params_file, scope=self.scope)
        for n in raw:
            val = self.scope.find_var(n)
            if n in scaled:
                wq, scale = quantize_weight_int8(val)
                self.scope.set(n, torch.from_numpy(wq).to(val.device))
                self.scope.set(n + SCALE_VAR_SUFFIX,
                               torch.from_numpy(scale).to(val.device))
            elif self.config._bf16 and val.dtype == torch.float32:
                self.scope.set(n, val.to(torch.bfloat16))

    def _cold_export(self, cache_dir: str) -> None:
        """Export the forward with a dynamic batch and without its weights,
        store it, and serve the module read back from the stored bytes; a
        program that cannot be exported is served without the cache."""
        if self.host_control_flow:
            stat_add("STAT_program_cache_unexportable")
            return
        params = self._persistables()
        try:
            ep = self._export(self._cache_feeds, dynamic_batch=True,
                              params=params)
        except Exception:  # served as without the cache, and counted
            stat_add("STAT_program_cache_unexportable")
            return
        sig = self._signature(ep, self._cache_feeds, "dyn")
        sig["params"] = list(params)
        # the module of the bytes stored, as a warm process reads them
        payload = program_cache.store_program(cache_dir, self.fingerprint,
                                              ep, sig)
        self._use_module(program_cache.read_program(payload)[0], sig)

    def _persistables(self) -> Dict[str, torch.Tensor]:
        """The program's persistables in the scope, by name."""
        out = {}
        for v in self.program.persistable_vars():
            val = self.scope.find_var(v.name)
            if isinstance(val, torch.Tensor):
                out[v.name] = val
        return out

    def _use_module(self, ep, sig: dict) -> None:
        self._module = ep.module()
        self._params = {n: self.scope.find_var(n) for n in sig["params"]}
        self._feed_dtypes = {f["name"]: getattr(torch, f["dtype"])
                             for f in sig["feeds"]}

    def _cast_params_bf16(self):
        for v in self.program.list_vars():
            if not v.persistable:
                continue
            val = self.scope.find_var(v.name)
            if isinstance(val, torch.Tensor) and val.dtype == torch.float32:
                self.scope.set(v.name, val.to(torch.bfloat16))

    # --- handles --------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self.feed_names)

    def get_output_names(self) -> List[str]:
        return list(self.fetch_names)

    def get_input_handle(self, name: str) -> PredictorTensor:
        if name not in self.feed_names:
            raise KeyError(f"no input {name!r} (inputs: {self.feed_names})")
        return PredictorTensor(name, self, True)

    def get_output_handle(self, name: str) -> PredictorTensor:
        if name not in self.fetch_names:
            raise KeyError(f"no output {name!r} (outputs: "
                           f"{self.fetch_names})")
        return PredictorTensor(name, self, False)

    def run(self, feeds: Optional[Sequence[np.ndarray]] = None):
        """Run on positional ``feeds`` (or on what the input handles were
        given); returns the fetches as numpy arrays. With shape buckets
        the batch is padded up to the ladder and the rows sliced back."""
        if feeds is not None:
            self._feeds = dict(zip(self.feed_names, feeds))
        missing = [n for n in self.feed_names if n not in self._feeds]
        if missing:
            raise RuntimeError("missing inputs: %s" % missing)
        # the "serving/predict" telemetry span goes with ROADMAP.md A7
        ladder = self._ladder()
        if ladder:
            outs = self._run_bucketed(dict(self._feeds), ladder)
        else:
            outs = self._eager(dict(self._feeds))
        self._outputs = dict(zip(self.fetch_names, outs))
        return [self._outputs[n] for n in self.fetch_names]

    def _eager(self, feeds) -> List[np.ndarray]:
        if self._module is not None:
            with torch.no_grad():
                outs = self._module(self._params, self._module_feeds(feeds))
            return [as_numpy(o) for o in outs]
        return self.exe.run(self.program, feed=feeds,
                            fetch_list=list(self.fetch_names),
                            scope=self.scope)

    def _module_feeds(self, feeds) -> Dict[str, torch.Tensor]:
        """Feeds as the exported module takes them: on the device, in the
        dtypes it was traced with."""
        out = {}
        for n, v in feeds.items():
            t = _as_feed(v, self.device)
            want = self._feed_dtypes.get(n)
            out[n] = t if want is None or t.dtype == want else t.to(want)
        return out

    # --- shape buckets --------------------------------------------------
    def _ladder(self) -> List[int]:
        sb = self.config._shape_buckets
        if sb is None:
            return []
        if sb is True:
            return parse_bucket_ladder(
                get_flag("FLAGS_predictor_shape_buckets"))
        return list(sb)

    @staticmethod
    def _bucket_sig(arrs: Dict[str, np.ndarray]) -> tuple:
        return tuple(sorted((n, tuple(v.shape), str(v.dtype))
                            for n, v in arrs.items()))

    def _run_bucketed(self, feeds: Dict[str, Any], ladder: List[int]):
        arrs = {n: np.asarray(v) for n, v in feeds.items()}
        # the shared leading dim is the batch; feeds that disagree on it
        # run as they are
        batches = {v.shape[0] for v in arrs.values() if v.ndim}
        if len(batches) != 1:
            stat_add("STAT_predictor_bucket_skip")
            return self._eager(arrs)
        b = batches.pop()
        target = bucket_or_exact(b, ladder, "STAT_predictor_bucket_overflow")
        if self._autotune and target != b:
            target = self._dispatch_target(arrs, b, target, ladder)
        return self._exec_padded(arrs, b, target, ladder)

    # --- adaptive bucket dispatch (autotune.py) ---------------------------
    def _program_token(self) -> Optional[str]:
        """The program's identity across processes for the policy key (the
        cache's fingerprint when there is one); None when it cannot be
        fingerprinted, and the bucket form then stays."""
        if self.fingerprint is None and self.program is not None:
            self.fingerprint = self.program.fingerprint(
                fetch_names=list(self.fetch_names), device=self.device,
                extra=(self.config._bf16, self.quant_mode))
        return self.fingerprint

    def _dispatch_target(self, arrs: Dict[str, Any], b: int, target: int,
                         ladder: List[int]) -> int:
        """The bucket-or-exact choice of this (rows, bucket) key: one dict
        lookup once tuned; a miss times both forms in turns on this request
        (``autotune.tune_two_forms``) and keeps the winner, which only a
        form whose rows are bitwise the bucket form's can be."""
        from . import autotune as _at
        prog = self._program_token()
        if prog is None:
            return target
        key_meta = {"kind": "predictor", "prog": prog, "rows": int(b),
                    "bucket": int(target), "qm": self.quant_mode,
                    "backend": _at.backend_of(self.device)}
        entry = _at.policy().resolve(_at.key_for(key_meta))
        if entry is not None:
            stat_add("STAT_autotune_cache_hits")
        else:
            entry = _at.tune_two_forms(
                key_meta, program_cache_dir=self.config.cache_dir(),
                forms={"bucket": lambda: self._exec_padded(arrs, b, target,
                                                           ladder),
                       "exact": lambda: self._exec_padded(arrs, b, b,
                                                          ladder)},
                reference="bucket", compare=_bitwise_rows)
        if entry is not None and entry.get("form") == "exact":
            return b
        return target

    def _padded(self, arrs: Dict[str, np.ndarray], target: int,
                ladder: List[int]):
        """(feeds padded to ``target`` rows and the other bucketed axes to
        the ladder, elements added, whether every padded extent is on the
        ladder)."""
        padded, pad_elems, on_ladder = {}, 0, target in ladder
        for n, v in arrs.items():
            if not v.ndim:
                padded[n] = v
                continue
            widths = [(0, 0)] * v.ndim
            widths[0] = (0, target - v.shape[0])
            for ax in self.config._bucket_axes:
                if ax and ax < v.ndim:
                    t = bucket_for(v.shape[ax], ladder)
                    if t is None:
                        on_ladder = False
                    elif t != v.shape[ax]:
                        widths[ax] = (0, t - v.shape[ax])
            if any(w for _, w in widths):
                nv = np.pad(v, widths)
                pad_elems += nv.size - v.size
                padded[n] = nv
            else:
                padded[n] = v
        return padded, pad_elems, on_ladder

    def _exec_padded(self, arrs: Dict[str, Any], b: int, target: int,
                     ladder: List[int]):
        """Pad to ``target`` rows, run (one CUDA graph a signature on the
        card when every extent is on the ladder), slice the row outputs
        back to ``b``."""
        padded, pad_elems, on_ladder = self._padded(arrs, target, ladder)
        if pad_elems:
            stat_add("STAT_predictor_pad_elements", pad_elems)
        if target != b:
            stat_add("STAT_predictor_pad_rows", target - b)
        sig = self._bucket_sig(padded)
        if sig in self._warm_sigs:
            stat_add("STAT_predictor_bucket_hit")
        else:
            self._warm_sigs.add(sig)
            stat_add("STAT_predictor_bucket_cold")
        # the /programz tag of the JAX package (program accounting) goes
        # with ROADMAP.md A7
        if self._graphs_on() and on_ladder:
            if self.host_control_flow:
                stat_add("STAT_predictor_graph_refused")
                self.bucket_paths.append("eager")
                outs = self._eager(padded)
            else:
                self.bucket_paths.append("graph")
                outs = self._run_graph(sig, padded)
        else:
            outs = self._eager(padded)
        if target != b:
            outs = [o[:b] if o.ndim and o.shape[0] == target else o
                    for o in outs]
        return outs

    def _graphs_on(self) -> bool:
        """Bucketed signatures run as CUDA graphs: on the card."""
        return self.device.type == "cuda"

    def _run_graph(self, sig: tuple, feeds: Dict[str, np.ndarray]):
        entry = self._graphs.get(sig)
        if entry is None:
            return self._capture(sig, feeds)
        for n, buf in entry.feeds.items():
            buf.copy_(torch.from_numpy(np.ascontiguousarray(feeds[n])))
        entry.graph.replay()
        stat_add("STAT_predictor_graph_replay")
        # on the stream of the replay: each copy waits for the graph, and
        # is a new host array that the next replay leaves alone
        return [as_numpy(t) for t in entry.fetches]

    def _capture(self, sig: tuple, feeds: Dict[str, np.ndarray]):
        """The cold run of a signature: the program eagerly on the capture
        stream (its fetches are returned), then the op loop captured over
        static copies of the feeds into one graph of the shared pool."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            if self._module is not None:
                static = {n: t.clone() for n, t in
                          self._module_feeds(feeds).items()}
            else:
                static = {n: _as_feed(v, self.device).clone()
                          for n, v in feeds.items()}
            outs = self._eager(static)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                fetches = self._captured(static)
        except Exception as e:
            raise RuntimeError(
                f"Predictor: capturing the bucket {sig} as a CUDA graph "
                f"failed ({e}); the notes name the op that broke it") from e
        self._graphs[sig] = _BucketGraph(graph, static, fetches)
        stat_add("STAT_predictor_graph_capture")
        return outs

    def _captured(self, static: Dict[str, torch.Tensor]) -> list:
        """The forward over static feeds, as a capture records it: the
        cached module, else the executor's op loop."""
        if self._module is not None:
            with torch.no_grad():
                return list(self._module(self._params, static))
        env, _, ctx = self.exe.bind(self.program, static, self.scope)
        self.exe._run_block(self.program, env, ctx)
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch {missing}: no op of the program produced "
                           "it and it is not fed")
        return [env[n] for n in self.fetch_names]

    def warmup_buckets(self, example_feeds: Sequence,
                       max_bucket: Optional[int] = None) -> Dict:
        """Run every bucket of the ladder once on zero feeds (trailing
        dims and dtypes from ``example_feeds``, one a feed): on the card
        each becomes a captured graph, largest first, so that the smaller
        graphs reuse the shared pool. Through
        ``program_cache.warmup_ladder``: returns {bucket: {"seconds",
        "disk_warm", "graph"}}, "disk_warm" whether the forward came from
        the program cache, or {"error"} for a bucket that failed."""
        ladder = self._ladder()
        if not ladder:
            raise RuntimeError(
                "shape bucketing is not enabled on this predictor "
                "(Config.switch_shape_bucketing) or the ladder is empty")
        full = ladder
        if max_bucket is not None:
            ladder = [x for x in ladder if x <= max_bucket] or ladder[:1]
        if len(example_feeds) != len(self.feed_names):
            raise ValueError("expected %d example feeds (%s), got %d"
                             % (len(self.feed_names), self.feed_names,
                                len(example_feeds)))
        examples = {n: np.asarray(v)
                    for n, v in zip(self.feed_names, example_feeds)}

        def run_one(bkt):
            feeds = {}
            for n, v in examples.items():
                if not v.ndim:
                    feeds[n] = v
                    continue
                feeds[n] = np.zeros((bkt,) + v.shape[1:], v.dtype)
            feeds, _, on_ladder = self._padded(feeds, bkt, full)
            sig = self._bucket_sig(feeds)
            graph = self._graphs_on() and on_ladder
            if graph and sig not in self._graphs:
                self._capture(sig, feeds)
            elif not graph:
                self._eager(feeds)
            self._warm_sigs.add(sig)
            return {"graph": graph, "disk_warm": self.cache_hit}

        return program_cache.warmup_ladder(sorted(ladder, reverse=True),
                                           run_one)

    # --- the serving artifact ---------------------------------------------
    def _export(self, example: Dict[str, Any], dynamic_batch: bool,
                params: Optional[Dict[str, torch.Tensor]] = None):
        """``torch.export`` (non-strict) of the forward over ``example``
        feeds: the cached module's, else ``_Forward`` of the program. With
        ``params`` the persistables are its first argument (the program
        cache's graph without weights), else its buffers (``_Bound``, the
        artifact). With ``dynamic_batch`` every feed's leading dim is one
        symbol. A program whose lowering reads a value on the host raises
        naming the op."""
        if self.host_control_flow:
            raise ValueError(
                f"export_serialized: op {self.host_control_flow[0]!r} reads "
                "its predicate on the host (Executor.host_syncs); a traced "
                "forward would freeze its branch, so this program cannot be "
                "exported")
        feeds = self._module_feeds(example) if self._module is not None \
            else {n: _as_feed(v, self.device) for n, v in example.items()}
        dyn = None
        if dynamic_batch:
            # an example of one row would specialize the batch to 1
            feeds = {n: t.repeat(2, *[1] * (t.dim() - 1))
                     if t.dim() and t.shape[0] == 1 else t
                     for n, t in feeds.items()}
            batch = torch.export.Dim("batch", min=1, max=1 << 20)
            dyn = {n: ({0: batch} if t.dim() else None)
                   for n, t in feeds.items()}
        inner = self._module if self._module is not None else _Forward(
            self.exe, self.program, self.fetch_names)
        if params is None:
            module, args = _Bound(inner, self._params if self._module
                                  is not None else self._persistables()), \
                (feeds,)
            dyn = None if dyn is None else (dyn,)
        else:
            module, args = inner, (params, feeds)
            dyn = None if dyn is None else ({n: None for n in params}, dyn)
        try:
            return torch.export.export(module, args, dynamic_shapes=dyn,
                                       strict=False)
        except Exception as e:
            op = _host_op(e)
            raise RuntimeError(
                "export_serialized: the forward cannot be exported"
                + (f" ({op}: a value read on the host or a shape the trace "
                   "cannot follow)" if op else "")
                + f": {type(e).__name__}: {e}") from e

    def _signature(self, ep, example: Dict[str, Any], batch) -> dict:
        """signature.json of an exported forward."""
        feeds = []
        for n in self.feed_names:
            t = _as_feed(example[n], torch.device("cpu"))
            want = self._feed_dtypes.get(n, t.dtype)
            feeds.append({"name": n, "dtype": str(want).split(".")[-1],
                          "shape": list(t.shape[1:])})
        ops = _kernel_ops(ep)
        from .kernels import serving_ops
        cuda = self.device.type == "cuda"
        return {"feed_names": list(self.feed_names),
                "fetch_names": list(self.fetch_names), "feeds": feeds,
                "batch": batch, "device": self.device.type,
                "kernel_ops": ops,
                "kernel_libraries": sorted({serving_ops.LIBRARY_OF[o]
                                            for o in ops}),
                "build": self._build_info() if cuda else None,
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "card": torch.cuda.get_device_name(self.device) if cuda
                else "cpu"}

    def _build_info(self) -> dict:
        from .kernels import _build
        return {"capability": list(torch.cuda.get_device_capability(
                    self.device)), "cuda": torch.version.cuda,
                "nvcc_flags": list(_build.NVCC_FLAGS)}

    def export_serialized(self, path: str, example_feeds: Sequence,
                          dynamic_batch: bool = False) -> dict:
        """Write the pass-pipelined forward as a serving artifact that
        ``SerializedPredictor``, ``serving_core.SerializedCore`` and the C
        ABI serve without the program, the registry or the framework (the
        reference's ``SaveOptimModel``): ``model.pt2``, ``signature.json``,
        ``serving_ops.py``, ``serving_core.py`` and ``kernels/`` (the
        sources of the kernels the graph calls, and their ``.so`` when it
        runs on the card). ``dynamic_batch`` makes the leading dim of
        every feed one symbol, so that one artifact serves any batch
        (padded to ``PADDLE_TPU_SHAPE_BUCKETS``); a static export serves
        batches up to its example's, padded up. Returns the signature."""
        from .kernels import _build, serving_ops, traced
        if len(example_feeds) != len(self.feed_names):
            raise ValueError("expected %d example feeds (%s), got %d"
                             % (len(self.feed_names), self.feed_names,
                                len(example_feeds)))
        example = {n: np.asarray(v)
                   for n, v in zip(self.feed_names, example_feeds)}
        traced.register()
        ep = self._export(example, dynamic_batch)
        rows = {v.shape[0] for v in example.values() if v.ndim}
        batch = "dyn" if dynamic_batch else (rows.pop() if len(rows) == 1
                                             else None)
        sig = self._signature(ep, example, batch)
        os.makedirs(path, exist_ok=True)
        torch.export.save(ep, os.path.join(path, "model.pt2"))
        with open(os.path.join(path, "signature.json"), "w") as f:
            json.dump(sig, f, indent=1)
        for name in ("serving_core.py", "kernels/serving_ops.py"):
            shutil.copy(os.path.join(_PACKAGE_DIR, name),
                        os.path.join(path, os.path.basename(name)))
        kdir = os.path.join(path, "kernels")
        os.makedirs(kdir, exist_ok=True)
        for lib in sig["kernel_libraries"]:
            shutil.copy(_build.CSRC_DIR / f"{lib}.cu", kdir)
            if self.device.type == "cuda":
                shutil.copy(_build.library_path(lib),
                            os.path.join(kdir, f"lib{lib}.so"))
        if sig["kernel_libraries"]:
            for header in _build.CSRC_DIR.glob("*.cuh"):
                shutil.copy(header, kdir)
        return sig


def _bitwise_rows(ref, val) -> bool:
    """Whether two forms' fetches are equal bit for bit."""
    if len(ref) != len(val):
        return False
    for x, y in zip(ref, val):
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        if x.shape != y.shape or x.dtype != y.dtype or \
                x.tobytes() != y.tobytes():
            return False
    return True


class SerializedPredictor:
    """Serve an ``export_serialized`` artifact: no program, no registry, no
    trace. A thin facade over ``serving_core.SerializedCore`` (the file the
    artifact ships for the C ABI); ``device`` as there (the card unless
    "cpu" is asked for). The kernel ops run through the package's wrappers,
    so their launch counters move. A bf16 fetch, which the core returns as
    raw uint16 words, is widened to float32 (exact), as ``Predictor``
    returns it."""

    def __init__(self, path: str, device=None):
        from .kernels import traced
        from .serving_core import SerializedCore
        traced.register()
        self._core = SerializedCore(path, device=device)
        self.feed_names = self._core.feed_names
        self.fetch_names = self._core.fetch_names

    @property
    def core(self):
        return self._core

    def get_input_names(self) -> List[str]:
        return list(self.feed_names)

    def get_output_names(self) -> List[str]:
        return list(self.fetch_names)

    def run(self, feeds: Sequence[np.ndarray]) -> List[np.ndarray]:
        return [(o.astype(np.uint32) << 16).view(np.float32)
                if o.dtype == np.uint16 else o for o in self._core.run(feeds)]

    def warmup_buckets(self, example_feeds: Sequence,
                       max_bucket: Optional[int] = None) -> Dict:
        return self._core.warmup_buckets(example_feeds, max_bucket)


def create_predictor(config: Config) -> Predictor:
    """``CreatePaddlePredictor``."""
    return Predictor(config)
