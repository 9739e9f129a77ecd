#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

1. environment — torch/CUDA versions and the card's name and power limit
   (nvidia-smi); exits non-zero when torch sees no CUDA card;
2. build — compiles every kernel source of the port with nvcc, one
   process per source, all started together;
3. kernels — each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge shapes, and timed with CUDA
   events beside its plain version, one PyTorch library call computing
   the same function (timed only; the port never calls it) and the bound
   of the card (bytes or operations over the H100's peak rates);
4. parity — the slice on the card against the slice on the CPU from one
   initial model (HFL, AFL, CFL x loop, vectorized; 4 clients, 2
   rounds), round models compared after every event, and a second card
   run of the same seed required to be bitwise equal to the first;
5. study — the main path: `paper_study.run_study("quick")` on the card
   under the vectorized engine, then its mnist-like half under the loop
   engine, with every kernel's launch count set to 0 just before and read
   just after. Fails on a non-finite metric, an accuracy floor missed, or
   a path kernel launched no time.

The last lines are the card's nvidia-smi line, one JSON object
{"kernels": [...]} and the result {"ok": true, "device": {...}}. Full
results also go to chiprun_out/chip_smoke.json.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores


def _phase(name):
    print(f"\n== {name}", flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3 -----------------------------------------------------------------

def _time_ms(fn, samples=100, inner=10):
    """Median over `samples` of the mean time of `inner` back-to-back
    calls, by CUDA events, after a warmup."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _graph_ms(fn, inner=100, samples=20):
    """Device time per call with the host's launch cost removed: `inner`
    calls captured in one CUDA graph, the median replay over `inner`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _fedavg_bound(C, N, itemsize):
    """Least time for the work: each input read once, the output written
    once; 2*C*N float32 operations."""
    nbytes = C * N * itemsize + C * 4 + N * itemsize
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2 * C * N / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


MAIN_SHAPES = [(2, 7900), (4, 7900), (8, 7900)]      # CFL merge, HFL/AFL
EDGE_SHAPES = [(1, 1), (3, 37), (5, 4097), (16, 1 << 20)]


def kernel_phase():
    import torch
    from repro_torch.kernels import fedavg_agg as fa

    gen = torch.Generator().manual_seed(0)
    cases = ([(C, N, torch.float32, True) for C, N in MAIN_SHAPES]
             + [(C, N, torch.float32, False) for C, N in EDGE_SHAPES]
             + [(4, 5000, torch.bfloat16, False)])
    rows = []
    for C, N, dtype, main in cases:
        x = torch.randn((C, N), generator=gen).to("cuda", dtype)
        w = torch.softmax(torch.randn((C,), generator=gen), 0).cuda()
        before = fa.launches
        out = fa.fedavg_agg(x, w)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            raise SystemExit("fedavg_agg: the wrapper did not launch")
        exp = fa.fedavg_agg_torch(x, w)
        err = float((out.float() - exp.float()).abs().max())
        tol = 1e-6 if dtype == torch.float32 else 2e-2
        row = {"C": C, "N": N, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "tol": tol}
        if not (out.dtype == dtype and out.shape == (N,) and err <= tol):
            raise SystemExit(f"fedavg_agg disagrees with its plain version: "
                             f"{row}")
        if main:
            fns = {"": lambda: fa.fedavg_agg(x, w),
                   "plain_": lambda: fa.fedavg_agg_torch(x, w),
                   "library_": lambda: w @ x}             # yardstick only
            for key, fn in fns.items():
                row[f"{key}ms"] = _time_ms(fn)
                row[f"{key}graph_ms"] = _graph_ms(fn)
            row["bound_ms"], row["bound_by"] = _fedavg_bound(
                C, N, x.element_size())
        print("  fedavg_agg", json.dumps(row), flush=True)
        rows.append(row)
    return {"fedavg_agg": rows}


# -- phase 4 -----------------------------------------------------------------

PARITY_CFG = dict(num_clients=4, num_groups=2, rounds=2, local_batch_size=32,
                  lr=0.03, momentum=0.9, seed=0)


def parity_phase(device="cuda", reference="cpu"):
    """The slice on `device` against the slice on `reference`, event by
    event. Tolerance 1e-4 (abs and rel); HFL 1e-3, because its two-tier
    schedule amplifies float reassociation in near-tied max-pool windows
    to ~3e-4 after 2 rounds (the reference's own two engines differ by as
    much; tests/test_torch_simulation.py)."""
    import numpy as np
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.tree import tree_leaves

    ds = mnist_like(seed=0, n_train=512, n_test=128)
    report = {}
    for strategy in ("hfl", "afl", "cfl"):
        tol = 1e-3 if strategy == "hfl" else 1e-4
        for engine in ("loop", "vectorized"):
            fl = FLConfig(strategy=strategy, engine=engine, **PARITY_CFG)
            # the third run repeats the first: one seed, bitwise one result
            sims = [FederatedSimulation(fl, ds, device=d)
                    for d in (device, reference, device)]
            states = [s.strategy.init_state(s) for s in sims]
            diffs = []
            for ev in range(fl.rounds):
                for i, s in enumerate(sims):
                    states[i], _, _ = s.strategy.run_event(s, states[i], ev)
                a, b, again = (tree_leaves(s.strategy.round_model(st))
                               for s, st in zip(sims, states))
                if not all(x.equal(y) for x, y in zip(a, again)):
                    raise SystemExit(
                        f"parity {strategy}/{engine} event {ev}: two runs "
                        f"of one seed on {device} differ")
                diff = 0.0
                for x, y in zip(a, b):
                    x = x.cpu().double().numpy()
                    y = y.cpu().double().numpy()
                    if not np.allclose(x, y, atol=tol, rtol=tol):
                        raise SystemExit(
                            f"parity {strategy}/{engine} event {ev}: "
                            f"{device} vs {reference} beyond {tol}")
                    diff = max(diff, float(np.abs(x - y).max()))
                diffs.append(diff)
            report[f"{strategy}/{engine}"] = {"max_abs_diff_per_event": diffs,
                                              "tol": tol}
            print(f"  {strategy}/{engine}: max |{device} - {reference}| per "
                  f"event {diffs} (tol {tol})", flush=True)
    return report


# -- phase 5 -----------------------------------------------------------------

ACC_FLOOR = {"mnist-like": 0.90, "fashion-like": 0.40}
_METRICS = ("train_accuracy", "test_accuracy", "build_time_s",
            "classification_time_s", "precision", "recall", "f1",
            "balanced_accuracy")


def _check_run(r, engine):
    values = [getattr(r, k) for k in _METRICS] + list(r.round_train_acc) \
        + list(r.round_train_loss) + list(r.round_test_acc)
    if not all(math.isfinite(v) for v in values):
        raise SystemExit(f"{r.dataset} {r.strategy} {engine}: "
                         f"non-finite metric")
    if r.test_accuracy < ACC_FLOOR[r.dataset]:
        raise SystemExit(f"{r.dataset} {r.strategy} {engine}: test accuracy "
                         f"{r.test_accuracy} below {ACC_FLOOR[r.dataset]}")
    launches = r.extra["kernel_launches"]["fedavg_agg"]
    if (r.strategy in ("hfl", "afl") or engine == "vectorized") \
            and launches == 0:
        raise SystemExit(f"{r.dataset} {r.strategy} {engine}: fedavg_agg "
                         f"never launched")


def study_phase(device="cuda", scale="quick"):
    from repro_torch import paper_study
    from repro_torch.kernels import fedavg_agg as fa

    fa.launches = 0                      # the main path's count starts here
    t0 = time.perf_counter()
    runs = {"vectorized": paper_study.run_study(
                scale, device=device, engine="vectorized"),
            "loop": paper_study.run_study(
                scale, device=device, engine="loop", datasets=("mnist",))}
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    launches = fa.launches
    seconds = time.perf_counter() - t0
    if device == "cuda" and launches == 0:
        raise SystemExit("main path: fedavg_agg was launched no time")
    out = {"seconds": seconds, "fedavg_agg_launches": launches, "runs": []}
    for engine, results in runs.items():
        print(f"  -- {engine} engine", flush=True)
        paper_study.print_tables(results)
        for r in results:
            _check_run(r, engine)
            out["runs"].append(dict(
                r.row(), engine=engine,
                fedavg_agg_launches=r.extra["kernel_launches"]["fedavg_agg"],
                warmup_time_s=r.warmup_time_s,
                round_train_loss=r.round_train_loss,
                round_test_acc=r.round_test_acc))
        out[f"claims_{engine}"] = {
            k: bool(v) for k, v in paper_study.claims_check(results).items()}
    print("  launches per run: " + ", ".join(
        f"{r['dataset']}/{r['strategy']}/{r['engine']}="
        f"{r['fedavg_agg_launches']}" for r in out["runs"]))
    print(f"  main path: fedavg_agg launched {launches} times in "
          f"{seconds:.1f}s", flush=True)
    return out


# -- driver ------------------------------------------------------------------

def main():
    _phase("environment")
    import torch
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no CUDA card",
              file=sys.stderr)
        sys.exit(2)
    card = _card_line()
    print(card, flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    _phase("build")
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"  built {sorted(libs)} in {build_s:.2f}s", flush=True)
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling" in line):
                print("  " + line.strip())

    _phase("kernels")
    kernels = kernel_phase()
    _phase("parity: card against CPU")
    parity = parity_phase("cuda", "cpu")
    _phase("study (main path)")
    study = study_phase("cuda", "quick")

    rows = kernels["fedavg_agg"]
    rep = next(r for r in rows if (r["C"], r["N"]) == (4, 7900) and "ms" in r)
    entry = {
        "name": "fedavg_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_agg.cu",
        "replaces": "src/repro/kernels/fedavg_agg.py:50",
        "launches": study["fedavg_agg_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"], "shape": [4, 7900],
        "shapes": [r for r in rows if "ms" in r]}
    doc = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "build_s": build_s,
           "kernels": kernels, "parity": parity, "study": study}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(doc, indent=1))

    print("kernels " + json.dumps([{
        "name": "fedavg_agg", "replaces": entry["replaces"],
        "C": r["C"], "N": r["N"], "max_err": r["max_abs_err"],
        "kernel_us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
        "library_us": r["library_ms"] * 1e3, "bound_us": r["bound_ms"] * 1e3,
        "kernel_graph_us": r["graph_ms"] * 1e3,
        "plain_graph_us": r["plain_graph_ms"] * 1e3,
        "library_graph_us": r["library_graph_ms"] * 1e3,
        "launches": entry["launches"]} for r in entry["shapes"]]))
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
