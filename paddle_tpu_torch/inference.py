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

Not ported yet, raising ``NotImplementedError``: weight-only quantized
serving (``enable_quant``, ``ROADMAP.md`` A4 item 3), SPMD serving
(``enable_spmd``, A6), the program cache, adaptive bucket dispatch and
the serialized artifact (``enable_program_cache``, ``switch_autotune``,
``export_serialized``, ``SerializedPredictor``, A5). The
``serving/predict`` telemetry span and its ``TIMER_predictor_run_us``
go with A7.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import device as _device
from . import io as _io
from .core.control_flow import HOST_PREDICATE_OPS
from .core.executor import Executor, _as_feed, as_numpy
from .core.passes import apply_pass
from .core.scope import Scope
from .flags import get_flag
from .monitor import stat_add

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
    parameter files), the device, the pass pipeline, bf16 and the shape
    buckets."""

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

    # --- not ported yet -------------------------------------------------
    def enable_quant(self, mode: str = "int8"):
        raise NotImplementedError(
            "Config.enable_quant: weight-only quantized serving is not "
            "ported yet (ROADMAP.md A4 item 3)")

    def disable_quant(self):
        pass  # unquantized is the only mode

    def switch_autotune(self, x: bool = True):
        if x:
            raise NotImplementedError(
                "Config.switch_autotune: adaptive bucket dispatch is not "
                "ported yet (ROADMAP.md A5)")

    def enable_spmd(self, plan_or_spec, data_axis: str = "dp"):
        raise NotImplementedError(
            "Config.enable_spmd: SPMD serving is not ported yet "
            "(ROADMAP.md A6)")

    def disable_spmd(self):
        pass

    def enable_program_cache(self, cache_dir: Optional[str] = None):
        raise NotImplementedError(
            "Config.enable_program_cache: the program cache is not ported "
            "yet (ROADMAP.md A5)")

    def disable_program_cache(self):
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
        self.program, self.feed_names, self.fetch_names = \
            _io.load_inference_model(
                config.model_dir, self.exe, model_filename=config.prog_file,
                params_filename=config.params_file, scope=self.scope)
        if config._ir_optim:
            for name in config.pass_builder().passes():
                # fetch targets keep their producers through any fusion
                self.program = apply_pass(self.program, name,
                                          protected=set(self.fetch_names))
        if config._bf16:
            self._cast_params_bf16()
        self._feeds: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, np.ndarray] = {}
        # bucketed signatures already run: hits against cold first runs
        self._warm_sigs: set = set()
        self._graphs: Dict[tuple, _BucketGraph] = {}
        self._graph_pool = None
        self._capture_stream = None
        # a structural op that reads its predicate on the host (while,
        # cond, conditional_block) cannot be captured: its branch would be
        # frozen at the capture's; such a program's buckets run eagerly
        self.host_control_flow = sorted({
            op.type for blk in self.program.blocks for op in blk.ops
            if op.type in HOST_PREDICATE_OPS})
        # how each bucketed run went: "graph", or "eager" for a program
        # with host_control_flow (the last 65536, as the path logs keep)
        self.bucket_paths: "collections.deque[str]" = collections.deque(
            maxlen=65536)

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
        return self.exe.run(self.program, feed=feeds,
                            fetch_list=list(self.fetch_names),
                            scope=self.scope)

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
        return self._exec_padded(arrs, b, target, ladder)

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
            static = {n: _as_feed(v, self.device).clone()
                      for n, v in feeds.items()}
            outs = self._eager(static)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        env, _, ctx = self.exe.bind(self.program, static, self.scope)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                self.exe._run_block(self.program, env, ctx)
        except Exception as e:
            raise RuntimeError(
                f"Predictor: capturing the bucket {sig} as a CUDA graph "
                f"failed ({e}); the notes name the op that broke it") from e
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch {missing}: no op of the program produced "
                           "it and it is not fed")
        self._graphs[sig] = _BucketGraph(
            graph, static, [env[n] for n in self.fetch_names])
        stat_add("STAT_predictor_graph_capture")
        return outs

    def warmup_buckets(self, example_feeds: Sequence,
                       max_bucket: Optional[int] = None) -> Dict:
        """Run every bucket of the ladder once on zero feeds (trailing
        dims and dtypes from ``example_feeds``, one a feed): on the card
        each becomes a captured graph, largest first, so that the smaller
        graphs reuse the shared pool. Returns {bucket: {"seconds",
        "graph"}}."""
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
        report = {}
        for bkt in sorted(ladder, reverse=True):
            feeds = {}
            for n, v in examples.items():
                if not v.ndim:
                    feeds[n] = v
                    continue
                feeds[n] = np.zeros((bkt,) + v.shape[1:], v.dtype)
            feeds, _, on_ladder = self._padded(feeds, bkt, full)
            sig = self._bucket_sig(feeds)
            t0 = time.perf_counter()
            graph = self._graphs_on() and on_ladder
            if graph and sig not in self._graphs:
                self._capture(sig, feeds)
            elif not graph:
                self._eager(feeds)
            self._warm_sigs.add(sig)
            report[bkt] = {"seconds": round(time.perf_counter() - t0, 4),
                           "graph": graph}
        return report

    def export_serialized(self, path: str, example_feeds: Sequence,
                          dynamic_batch: bool = False):
        raise NotImplementedError(
            "Predictor.export_serialized: the serialized serving artifact "
            "is not ported yet (ROADMAP.md A5)")


class SerializedPredictor:
    """The JAX package's StableHLO artifact server; the port's artifact
    format is not written yet."""

    def __init__(self, path: str):
        raise NotImplementedError(
            "SerializedPredictor: the serialized serving artifact is not "
            "ported yet (ROADMAP.md A5)")


def create_predictor(config: Config) -> Predictor:
    """``CreatePaddlePredictor``."""
    return Predictor(config)
