"""Data parallelism of the port on NCCL across the cards of one host: the
collectives, a 4-layer ERNIE-width step against one rank of the whole
batch, the int8 and fp8 wires, and ERNIE-large's step time with each wire
beside the same card's step without the exchange.

    python3 scripts/dp_nccl.py                 # one rank a card, NCCL
    python3 scripts/dp_nccl.py --nproc 4 --device cpu --backend gloo --small

Each rank is a process spawned by ``paddle_tpu_torch.parallel.spawn``
under the env contract (free ports; card ``rank % cards``); the ranks
write JSON that the parent holds and prints. Checks, each failing the
run (exit 1):
- every collective function against its rule on the rank's device, and
  no call staged through host memory on NCCL;
- 4 layers at ERNIE-large's widths, dropout off, fp32, 16 rows a rank:
  per-step losses and the parameters after 3 steps against rank 0's run
  of the whole batch without a mesh (``chip_smoke.DP_TOL``), every
  replica's parameters bitwise equal after every step, in fp32, int8 and
  fp8 (``FLAGS_collective_quant``), the wire's bytes the plan's census;
- ERNIE-large (24 layers), dropout 0.1, bf16, 32 rows a rank: the step's
  median ms over the timed steps (a barrier before each, the slowest
  rank's) with the exchange off ("plain": no mesh, each rank alone), and
  on the fp32, int8 and fp8 wires, and tokens/s of the whole group;
- ResNet-50 (BASELINE config 2: ``chip_smoke.resnet_model`` at 1000
  classes, 224 x 224, weights from ``chip_smoke.FLEET_SEED``), 64 images
  a rank, bf16 ``auto_cast``, Momentum(0.1, 0.9) through
  ``TrainStep(mesh=dp)``, every batch norm's statistics all-reduced over
  the group (106 all-reduces a step): the step's median ms over
  RESNET_STEPS (a barrier before each, the slowest rank's) and images/s
  of the group; the same steps with the batch norms' group hidden
  (``chip_smoke.HiddenGroup``: each rank's own statistics), in turns
  with the sound ones, whose difference is what the 106 all-reduces cost
  a step; a profiled step of each (device busy ms, NCCL kernels' ms);
  the parameters and running statistics bitwise equal on every rank.
``--parts`` picks "ernie" (the collectives, the parity runs, ERNIE-large's
times) and "resnet" (default both); ``--small`` swaps in a 2-layer,
128-wide config and 64 x 64 images to rehearse on the CPU. It imports no
JAX.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ROWS = 16          # a rank's rows in the parity runs
TIME_ROWS = 32     # a rank's rows in the timed ERNIE-large steps
WARM, TIMED = 2, 5
RESNET_ROWS = 64   # a rank's images in the ResNet-50 steps
RESNET_STEPS = 10


def small_config():
    from paddle_tpu_torch.models import bert
    bert.ernie_large_config = lambda: bert.BertConfig(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=256)
    cs.DP_GLOO_LAYERS = 2
    cs.DP_S = 64
    cs.RESNET_HW = 64
    global RESNET_ROWS, RESNET_STEPS
    RESNET_ROWS, RESNET_STEPS = 4, 2


def timed_steps(device, batch, mesh, quant):
    """ERNIE-large TrainStep(Adam(3e-5), bf16) on ``batch``: the median
    ms a step over TIMED steps after WARM, a barrier before each."""
    import paddle_tpu_torch
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Adam
    paddle_tpu_torch.set_flags({"FLAGS_collective_quant": quant})
    try:
        model, _ = cs.ernie_model(device)
        step = TrainStep(model, cs.dp_loss, Adam(cs.DP_LR), mesh=mesh,
                         amp_dtype="bfloat16")
        times, losses = [], []
        for i in range(WARM + TIMED):
            P.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(*batch)))
            times.append(time.perf_counter() - t0)
        del step, model
        torch.cuda.empty_cache()
        return 1e3 * float(np.median(times[WARM:])), losses
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_collective_quant": "off"})


def resnet_steps(device, mesh, rank, world):
    """RESNET_STEPS ResNet-50 steps (bf16, 64 images a rank) after WARM,
    the sound ones and those with the batch norms' group hidden in turns,
    then each in a block of RESNET_STEPS: the median ms of each (a barrier
    before each step), the host's ms inside the all-reduce calls and the
    allocator's device allocations over a block, a profiled step of each,
    the batch norms' all-reduces a step, and a digest of the parameters
    and running statistics after the sound steps."""
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.jit import TrainStep, state_of
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.optimizer import Momentum
    state = cs.resnet_state(resnet50(num_classes=cs.RESNET_CLASSES,
                                     device="cpu"), cs.FLEET_SEED)
    batch = cs.resnet_batch(RESNET_ROWS, device, cs.FLEET_SEED + 10 + rank)
    steps, losses = {}, []
    for label in ("sound", "hidden"):
        model = cs.resnet_model(state, device)
        steps[label] = (model, TrainStep(model, cs.fleet_loss,
                                         Momentum(cs.FLEET_LR, cs.FLEET_MU),
                                         mesh=mesh, amp_dtype="bfloat16"))

    def one(label):
        P.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "hidden":
            with cs.HiddenGroup():
                loss = steps[label][1](*batch)
        else:
            loss = steps[label][1](*batch)
        value = float(loss)
        return time.perf_counter() - t0, value
    for _ in range(WARM):
        for label in steps:
            one(label)
    # the host's time inside the collective calls, and the allocator's
    # device allocations, over the timed steps
    from paddle_tpu_torch.parallel import collective as C
    all_reduce = C.all_reduce
    inside = {"s": 0.0}

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return all_reduce(*a, **kw)
        finally:
            inside["s"] += time.perf_counter() - t0
    C.all_reduce = timed

    def allocs():
        return torch.cuda.memory_stats(device).get(
            "num_device_alloc", 0) if device.type == "cuda" else 0
    times = {label: [] for label in steps}
    blocks = {label: [] for label in steps}
    collective_ms = {label: 0.0 for label in steps}
    device_allocs = {}
    syncs = cs.bn_syncs()
    try:
        # in turns, then each in a block of RESNET_STEPS
        for _ in range(RESNET_STEPS):
            for label in steps:
                dt, value = one(label)
                times[label].append(dt)
                if label == "sound":
                    losses.append(value)
        for label in steps:
            inside["s"], a0 = 0.0, allocs()
            for _ in range(RESNET_STEPS):
                blocks[label].append(one(label)[0])
            collective_ms[label] = 1e3 * inside["s"] / RESNET_STEPS
            device_allocs[label] = allocs() - a0
    finally:
        C.all_reduce = all_reduce
    per = (cs.bn_syncs() - syncs) / (2 * RESNET_STEPS)
    prof = {}
    for label in steps:
        P.barrier()
        if label == "hidden":
            with cs.HiddenGroup():
                busy, n, _, names = cs.profile_step(
                    lambda: steps["hidden"][1](*batch))
        else:
            busy, n, _, names = cs.profile_step(
                lambda: steps["sound"][1](*batch))
        nccl = [v for k, v in names.items() if "nccl" in k.lower()]
        prof[label] = dict(busy_ms=busy, kernels=n,
                           nccl_ms=sum(v[0] for v in nccl),
                           nccl_kernels=sum(v[1] for v in nccl))
    model = steps["sound"][0]
    named = state_of(model)
    out = dict(ms={k: 1e3 * float(np.median(v)) for k, v in times.items()},
               block_ms={k: 1e3 * float(np.median(v))
                         for k, v in blocks.items()},
               collective_ms=collective_ms, device_allocs=device_allocs,
               losses=losses, bn_allreduces=per, profile=prof,
               digest=cs.digest(named[n] for n in sorted(named)))
    del steps, model
    torch.cuda.empty_cache()
    return out


def rank_main(out_dir, device_name, backend, small, parts=("ernie",
                                                           "resnet")):
    from paddle_tpu_torch import parallel as P
    if small:
        small_config()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = P.init_parallel_env(device=device_name, backend=backend)
    rank, world, device = P.get_rank(), env.world_size, env.device
    if device.type == "cpu":
        # a rehearsal: chip_smoke's runs synchronise the card, and its
        # profile reads the card's timeline
        torch.cuda.synchronize = torch.cuda.empty_cache = lambda *a: None
        cs.profile_step = lambda fn: (fn(), (0.0, 0, {}, {}))[1]
    report = dict(rank=rank, world=world, backend=env.backend,
                  device=str(device),
                  collectives=cs.check_collectives(device, rank, world))
    if "resnet" in parts:
        report["resnet"] = resnet_steps(device, env.mesh, rank, world)
    if "ernie" in parts:
        ernie_runs(report, device, env, rank, world)
    P.barrier()
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(report, f)
    P.destroy_parallel_env()


def ernie_runs(report, device, env, rank, world):
    """The parity runs and ERNIE-large's step times, into ``report``."""
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.models.bert import ernie_large_config
    vocab = ernie_large_config().vocab_size
    # parity: 4 layers, ROWS a rank, against rank 0's run of the whole
    whole = cs.dp_batch(ROWS * world, cs.DP_S, vocab, device, cs.DP_SEED + 3)
    local = tuple(tuple(x[rank * ROWS:(rank + 1) * ROWS] for x in part)
                  for part in whole)
    params = {}
    report["runs"] = {}
    for quant in ("off", "int8", "fp8"):
        res = cs.dp_train(device, local, None, quant, env.mesh)
        del res["init"]
        if quant == "off":
            params = res.pop("params")
        else:
            res.pop("params")
        report["runs"][quant] = res
    P.barrier()
    if rank == 0:
        one = cs.dp_train(device, whole, None, "off", None)
        report["one_losses"] = one["losses"]
        report["worst_param"] = cs._worst(params, one["params"])
        del one
    del params
    P.barrier()
    # ERNIE-large step times: plain (each rank alone), then each wire
    batch = cs.dp_batch(TIME_ROWS, cs.DP_S, vocab, device,
                        cs.DP_SEED + 10 + rank)
    report["times"] = {"plain": timed_steps(device, batch, None, "off")}
    for quant in ("off", "int8", "fp8"):
        report["times"][quant] = timed_steps(device, batch, env.mesh, quant)


def card_line(device_name):
    if device_name == "cpu":
        return "cpu"
    return cs.card_line()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks (default: one a card)")
    ap.add_argument("--device", default=None,
                    help="a rank's device: 'cpu', or None for its card")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--parts", default="ernie,resnet",
                    help="comma-separated: ernie, resnet")
    ap.add_argument("--timeout", type=float, default=1000.0)
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("dp_nccl: needs CUDA cards (or --device cpu)", file=sys.stderr)
        return 1
    if args.small:
        small_config()
    n = args.nproc or torch.cuda.device_count()
    card = card_line(args.device)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          f"{n} ranks", card, flush=True)
    from paddle_tpu_torch import parallel as P
    if args.device != "cpu" and "ernie" in args.parts.split(","):
        # once, before the ranks load the libraries (the ResNet path
        # launches none of the kernels)
        from paddle_tpu_torch.kernels import _build
        built = _build.build(("layer_norm", "flash_attention",
                              "flash_attention_bwd"))
        print("kernels built:", {k: round(v[0], 1) for k, v in built.items()},
              flush=True)
    out = tempfile.TemporaryDirectory()
    os.environ.setdefault("PADDLE_RENDEZVOUS_TIMEOUT_S", "300")
    t0 = time.perf_counter()
    try:
        P.spawn(rank_main, args=(out.name, args.device, args.backend,
                                 args.small, tuple(args.parts.split(","))),
                nprocs=n, timeout=args.timeout)
    except RuntimeError as e:
        print(f"dp_nccl FAILED: a rank failed: {e}", file=sys.stderr)
        return 1
    reports = []
    for r in range(n):
        with open(os.path.join(out.name, "rank%d.json" % r)) as f:
            reports.append(json.load(f))
    out.cleanup()
    fails = check(reports, card)
    print(f"dp_nccl: {n} ranks in {time.perf_counter() - t0:.1f} s; "
          f"{len(fails)} failed checks  [{card}]", flush=True)
    for msg in fails:
        print("FAILED:", msg)
    print(json.dumps({"ok": not fails}))
    return 1 if fails else 0


def check(reports, card):
    fails = []
    r0 = reports[0]
    n = len(reports)
    for r in reports:
        wrong, staged = r["collectives"]
        print(f"rank {r['rank']} on {r['device']} ({r['backend']}): "
              f"collectives wrong {wrong}, staged {staged:g}", flush=True)
        if wrong or (r["backend"] == "nccl" and staged):
            fails.append(f"rank {r['rank']}: collectives {wrong}, staged "
                         f"{staged:g}")
    if "resnet" in r0:
        fails += check_resnet(reports, card)
    if "runs" in r0:
        fails += check_ernie(reports, card)
    return fails


def check_resnet(reports, card):
    fails = []
    n = len(reports)
    res = [r["resnet"] for r in reports]
    ms = {k: max(x["ms"][k] for x in res) for k in res[0]["ms"]}
    equal = len({x["digest"] for x in res}) == 1
    losses = res[0]["losses"]
    p0 = res[0]["profile"]
    print(f"ResNet-50 {n} ranks x {RESNET_ROWS} images, bf16, Momentum, "
          f"batch norm across the ranks: {ms['sound']:.2f} ms a step (the "
          f"slowest rank's median of {RESNET_STEPS}), "
          f"{n * RESNET_ROWS / ms['sound'] * 1e3:.1f} images/s; losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; batch-norm "
          f"all-reduces a step {res[0]['bn_allreduces']:g}; parameters and "
          f"running statistics {'bitwise equal' if equal else 'DIFFER'} on "
          f"the {n} ranks  [{card}]", flush=True)
    print(f"ResNet-50 the same steps with each rank's own statistics (the "
          f"group hidden from batch norm): {ms['hidden']:.2f} ms a step; "
          f"the 106 all-reduces' share of the step "
          f"{(ms['sound'] - ms['hidden']) / ms['sound']:.3f} "
          f"({ms['sound'] - ms['hidden']:.2f} ms)  [{card}]", flush=True)
    bl = {k: max(x["block_ms"][k] for x in res) for k in res[0]["block_ms"]}
    print(f"ResNet-50 in blocks of {RESNET_STEPS}: sound {bl['sound']:.2f} "
          f"ms, {n * RESNET_ROWS / bl['sound'] * 1e3:.1f} images/s; hidden "
          f"{bl['hidden']:.2f} ms; share "
          f"{(bl['sound'] - bl['hidden']) / bl['sound']:.3f}; rank 0's host "
          f"ms a step inside the all-reduce calls "
          f"{res[0]['collective_ms']}; the allocator's device allocations "
          f"in each block {res[0]['device_allocs']}  [{card}]", flush=True)
    for label, p in p0.items():
        print(f"ResNet-50 profiled step, rank 0, {label}: device busy "
              f"{p['busy_ms']:.2f} ms in {p['kernels']} kernels, NCCL "
              f"kernels {p['nccl_kernels']} for {p['nccl_ms']:.2f} ms  "
              f"[{card}]", flush=True)
    if not equal:
        fails.append("ResNet-50: the replicas differ")
    if res[0]["bn_allreduces"] != 106 or not all(
            v == v for v in losses):
        fails.append(f"ResNet-50: {res[0]['bn_allreduces']} batch-norm "
                     f"all-reduces a step, losses {losses}")
    return fails


def check_ernie(reports, card):
    fails = []
    r0 = reports[0]
    n = len(reports)
    for quant, run in r0["runs"].items():
        digests = {tuple(r["runs"][quant]["digests"]) for r in reports}
        moved = {k.split('dtype="')[1][:-2]: v
                 for k, v in run["stats"].items()
                 if k.startswith("STAT_mesh_collective_bytes") and v}
        steps = cs.DP_GLOO_STEPS - 1
        want = {dt: nb * steps for dt, nb in run["census"].items()}
        # the loss's 4-byte all-reduce a step, by the ring model
        want["float32"] = want.get("float32", 0) + \
            int(2 * 4 * (n - 1) / n) * steps
        print(f"{quant}: losses {['%.6f' % v for v in run['losses']]}; "
              f"replicas {'bitwise equal' if len(digests) == 1 else 'DIFFER'}"
              f"; wire bytes a rank over steps 2-{cs.DP_GLOO_STEPS} "
              f"{moved}, census {want}", flush=True)
        if len(digests) != 1:
            fails.append(f"{quant}: replicas differ")
        if moved != want:
            fails.append(f"{quant}: wire bytes {moved}, census {want}")
        if not run["losses"][-1] < run["losses"][0]:
            fails.append(f"{quant}: losses not falling {run['losses']}")
    tol = cs.DP_TOL[None]
    err = max(abs(a - b) / abs(b) for a, b in
              zip(r0["runs"]["off"]["losses"], r0["one_losses"]))
    print(f"fp32 {n} ranks x {ROWS} rows against one rank of "
          f"{n * ROWS}: losses {err:.2e} relative (tol "
          f"{tol['loss_rtol']:g}), parameters within "
          f"{r0['worst_param']:.2e} (tol {tol['param_atol']:.1e})",
          flush=True)
    if err > tol["loss_rtol"] or r0["worst_param"] > tol["param_atol"]:
        fails.append("the ranks disagree with one rank")
    tokens = TIME_ROWS * cs.DP_S
    for what in ("plain", "off", "int8", "fp8"):
        ms = max(r["times"][what][0] for r in reports)
        group = n * tokens if what != "plain" else tokens
        label = "one rank alone (no exchange)" if what == "plain" else \
            f"{n} ranks, wire {'fp32' if what == 'off' else what}"
        print(f"ERNIE-large B={TIME_ROWS} a rank S={cs.DP_S} bf16, {label}:"
              f" {ms:.2f} ms a step (the slowest rank's median of {TIMED}),"
              f" {group / ms * 1e3:.0f} tokens/s  [{card}]", flush=True)
    return fails


if __name__ == "__main__":
    sys.exit(main())
