#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

1. environment — torch/CUDA versions and the card's name and power limit
   (nvidia-smi); exits non-zero when torch sees no CUDA card;
2. build — compiles every kernel source of the port with nvcc, one
   process per source, all started together;
3. kernels — each kernel (`fedavg_agg`, `trimmed_mean_agg`) against its
   plain PyTorch version on the card, at the main paths' shapes and at
   edge shapes, and timed with CUDA events beside its plain version, one
   PyTorch library call computing the same function where there is one
   (timed only; the port never calls it) and the bound of the card
   (bytes or operations over the H100's peak rates);
4. parity — the port on the card against the port on the CPU from one
   initial model (HFL, AFL, CFL x loop, vectorized; then five attack /
   defense configurations x loop, vectorized; 4 clients, 2 rounds),
   round models compared after every event, and a second card run of the
   same seed required to be bitwise equal to the first; then HFL with a
   Gaussian attacker at 4 clients, whose readings are printed beside the
   CPU engines' own gap (see `hfl4_phase`);
5. study — slice 1's main path: `paper_study.run_study("quick")` on the
   card under the vectorized engine, then its mnist-like half under the
   loop engine. Fails on a non-finite metric, an accuracy floor missed,
   or a path kernel launched no time;
6. adversarial study — slice 2's main path: the 32-client sign-flip
   acceptance family and the coverage scenarios through the scenario
   runner (`repro_torch.core.scenarios.run`) on the card. Fails on a
   non-finite metric, `trimmed_mean_agg` launched no time in a median or
   trimmed-mean aggregation run, median or trimmed mean recovering less
   than 0.90 of the no-attack macro-F1, or plain FedAvg under attack
   keeping more than half of it;
7. churn (slice 3 main path) — (a) `gossip_mix_agg` against its plain
   version on the card, with mixing matrices from real fault schedules
   (dead clients' identity rows must come back bit for bit), timed as
   the other kernels; (b) the port on the card against the port on the
   CPU under fault profiles (masked gossip with MTD, HFL quorum holds,
   AFL star with median, CFL under `mid`, FedAvgM with quorum holds,
   FedProx, FedAdam; both engines), event by event, with a bitwise repeat
   on the card; (c) the
   32-client churn study through the scenario runner: the colluding
   sign-flip pair with and without the moving-target ring, and a clean
   twin that mixes through `gossip_mix_agg` every round. Fails on a
   non-finite metric, a `faults` block that differs from the reference's
   recorded one (experiments/churn/churn_mtd_32c.json), or
   `gossip_mix_agg` launched no time in the clean twin or any time in a
   defended run.

Phases 5, 6 and 7(c) set every kernel's launch count to 0 just before
they start and read the counts just after.

The last lines are the card's nvidia-smi line, one JSON object
{"kernels": [...]} and the result {"ok": true, "device": {...}}. Full
results also go to chiprun_out/chip_smoke.json.
"""
import dataclasses
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


# CFL merge, HFL/AFL at 4 and 8 clients, the 32-client adversarial family
MAIN_SHAPES = [(2, 7900), (4, 7900), (8, 7900), (32, 7900)]
EDGE_SHAPES = [(1, 1), (3, 37), (5, 4097), (16, 1 << 20)]


def kernel_phase():
    return {"fedavg_agg": _fedavg_rows(),
            "trimmed_mean_agg": _trimmed_rows()}


def _fedavg_rows():
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
    return rows


def _cx_count(C):
    """Compare-exchanges of the bitonic network on Cp = next pow2 >= C
    rows: Cp/2 per stage, log2(Cp)(log2(Cp)+1)/2 stages."""
    lg = max(0, (C - 1).bit_length())
    return (1 << lg) // 2 * lg * (lg + 1) // 2


def _trimmed_bound(C, N, trim, itemsize):
    """Least time for the work: x read once, the output written once;
    per column 2 operations per compare-exchange (min and max) plus the
    C - 2*trim adds and one divide, in float32."""
    t_bytes = (C * N * itemsize + N * itemsize) / H100_BYTES_PER_S
    t_ops = (2 * _cx_count(C) + (C - 2 * trim) + 1) * N / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# (C, N, trim): trimmed mean at f = ceil(0.25 C) and median at 32 clients
# (the acceptance family), at 8 (median 3, f = 2) and 4 clients (f = 1)
TRIM_MAIN = [(32, 7900, 8), (32, 7900, 15), (8, 7900, 2), (8, 7900, 3),
             (4, 7900, 1)]
TRIM_EDGE = [(1, 37, 0), (2, 37, 0), (5, 4097, 2), (33, 4097, 8),
             (256, 7900, 64), (600, 300, 100), (16, 1 << 20, 4)]


def _same_values(out, exp):
    """(equal NaN/inf pattern, max |out - exp| over finite entries)."""
    import torch
    out, exp = out.float(), exp.float()
    fin = torch.isfinite(exp)
    pattern = bool(torch.equal(torch.isnan(out), torch.isnan(exp))
                   and torch.equal(out[torch.isinf(exp)],
                                   exp[torch.isinf(exp)])
                   and torch.isfinite(out[fin]).all())
    err = float((out[fin] - exp[fin]).abs().max()) if fin.any() else 0.0
    return pattern, err


def _trimmed_rows():
    import torch
    from repro_torch.kernels import robust_agg as ra

    gen = torch.Generator().manual_seed(1)
    ties = torch.randint(0, 3, (9, 300), generator=gen).float()
    infs = torch.randn((7, 300), generator=gen)
    infs[0, :50], infs[3, 25:75], infs[6, 280:] = (float("inf"),
                                                   -float("inf"),
                                                   float("inf"))
    nans = torch.randn((6, 300), generator=gen)
    nans[2, 5], nans[0, 17:19] = float("nan"), float("nan")
    cases = ([(torch.randn((C, N), generator=gen), t, True, "")
              for C, N, t in TRIM_MAIN]
             + [(torch.randn((C, N), generator=gen), t, False, "")
                for C, N, t in TRIM_EDGE]
             + [(ties, 2, False, "ties"), (infs, 2, False, "inf"),
                (nans, 1, False, "nan"),
                (torch.randn((4, 5000), generator=gen).bfloat16(), 1,
                 False, "")])
    rows = []
    for x, trim, main, kind in cases:
        x = x.cuda()
        C, N = x.shape
        before = ra.launches
        out = ra.trimmed_mean_agg(x, trim)
        torch.cuda.synchronize()
        if ra.launches != before + 1:
            raise SystemExit("trimmed_mean_agg: the wrapper did not launch")
        exp = ra.trimmed_mean_torch(x, trim)
        pattern, err = _same_values(out, exp)
        tol = 1e-6 if x.dtype == torch.float32 else 2e-2
        row = {"C": C, "N": N, "trim": trim, "kind": kind,
               "dtype": str(x.dtype).replace("torch.", ""),
               "max_abs_err": err, "tol": tol}
        if kind == "nan":
            pattern = pattern and bool(torch.isnan(out[[5, 17, 18]]).all())
        if not (out.dtype == x.dtype and out.shape == (N,) and pattern
                and err <= tol):
            raise SystemExit(f"trimmed_mean_agg disagrees with its plain "
                             f"version: {row}")
        if main:
            fns = {"": lambda: ra.trimmed_mean_agg(x, trim),
                   "plain_": lambda: ra.trimmed_mean_torch(x, trim),
                   # a step of the plain version, not a yardstick: no
                   # single PyTorch call computes a trimmed mean
                   "sort_": lambda: torch.sort(x, dim=0)}
            for key, fn in fns.items():
                row[f"{key}ms"] = _time_ms(fn)
                row[f"{key}graph_ms"] = _graph_ms(fn)
            row["bound_ms"], row["bound_by"] = _trimmed_bound(
                C, N, trim, x.element_size())
        print("  trimmed_mean_agg", json.dumps(row), flush=True)
        rows.append(row)
    too_many = torch.zeros((ra.MAX_CLIENTS + 1, 8), device="cuda")
    try:
        ra.trimmed_mean_agg(too_many, 1)
    except ValueError:
        pass
    else:
        raise SystemExit(f"trimmed_mean_agg took C = {ra.MAX_CLIENTS + 1}, "
                         f"above its stated maximum")
    return rows


# -- phase 4 -----------------------------------------------------------------

PARITY_CFG = dict(num_clients=4, num_groups=2, rounds=2, local_batch_size=32,
                  lr=0.03, momentum=0.9, seed=0)


# slice 2: attack x defense on each aggregation event (4 clients, all
# participating; 1 attacker at the default fraction 0.25). HFL runs 8
# clients so that each group of 4 trims f = 1; the 4-client HFL case,
# where f clamps to 0, is `hfl4_phase` below
ADV_PARITY = {
    "afl-signflip-median": dict(strategy="afl", attack="sign_flip",
                                attack_scale=2.0, defense="median"),
    "hfl-gauss-trimmed": dict(strategy="hfl", num_clients=8, attack="gauss",
                              attack_scale=0.5, defense="trimmed_mean"),
    "cfl-replace-clip": dict(strategy="cfl", attack="model_replace",
                             attack_scale=5.0, defense="norm_clip",
                             clip_tau=2.0),
    "afl-labelflip-trimmed": dict(strategy="afl", attack="label_flip",
                                  defense="trimmed_mean"),
    "afl-ring-signflip-median": dict(strategy="afl", afl_mode="gossip",
                                     attack="sign_flip", attack_scale=2.0,
                                     defense="median"),
}


def parity_cases():
    """(label, FLConfig kwargs) of every parity run: slice 1's strategies
    and slice 2's attack/defense configurations, under both engines."""
    cases = []
    for engine in ("loop", "vectorized"):
        for strategy in ("hfl", "afl", "cfl"):
            cases.append((f"{strategy}/{engine}",
                          dict(PARITY_CFG, strategy=strategy,
                               engine=engine)))
        for name, kw in ADV_PARITY.items():
            cases.append((f"{name}/{engine}",
                          dict(PARITY_CFG, participation=1.0,
                               engine=engine, **kw)))
    return cases


def _parity(label, make_sim, device, reference, gated=True):
    """Three runs of one config — on `device`, on `reference`, and on
    `device` again — driven event by event. After every event the round
    model (and HFL's group models) of the first must equal the third bit
    for bit and agree with the second within 1e-4 abs and rel; HFL 1e-3,
    because its two-tier schedule amplifies float reassociation in
    near-tied max-pool windows to ~3e-4 after 2 rounds (the reference's
    own two engines differ by as much; tests/test_torch_simulation.py).
    With `gated=False` the distance is printed, not held to the
    tolerance, and the round models must be finite.
    Returns (max |device - reference| per event, tol, the sims)."""
    import numpy as np
    from repro_torch.tree import tree_leaves

    sims = [make_sim(d) for d in (device, reference, device)]
    fl = sims[0].fl
    tol = 1e-3 if fl.strategy == "hfl" else 1e-4
    states = [s.strategy.init_state(s) for s in sims]

    def leaves(s, st):
        out = tree_leaves(s.strategy.round_model(st))
        return out + (tree_leaves(st["groups"]) if "groups" in st else [])

    diffs = []
    for ev in range(fl.rounds):
        for i, s in enumerate(sims):
            states[i], _, _ = s.strategy.run_event(s, states[i], ev)
        a, b, again = (leaves(s, st) for s, st in zip(sims, states))
        if not all(x.equal(y) for x, y in zip(a, again)):
            raise SystemExit(f"parity {label} event {ev}: two runs of "
                             f"one seed on {device} differ")
        diff = 0.0
        for x, y in zip(a, b):
            x = x.cpu().double().numpy()
            y = y.cpu().double().numpy()
            if not (np.isfinite(x).all() and np.isfinite(y).all()):
                raise SystemExit(f"parity {label} event {ev}: non-finite "
                                 f"round model")
            if gated and not np.allclose(x, y, atol=tol, rtol=tol):
                raise SystemExit(f"parity {label} event {ev}: {device} "
                                 f"vs {reference} beyond {tol}")
            diff = max(diff, float(np.abs(x - y).max()))
        diffs.append(diff)
    print(f"  {label}: max |{device} - {reference}| per event {diffs} "
          f"({f'tol {tol}' if gated else 'printed, not gated'})",
          flush=True)
    return diffs, tol, sims


def parity_phase(device="cuda", reference="cpu"):
    """The port on `device` against the port on `reference`, event by
    event (`_parity`), for slice 1's strategies and slice 2's attack /
    defense configurations."""
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.data.synthetic import mnist_like

    ds = mnist_like(seed=0, n_train=512, n_test=128)
    report = {}
    for label, kw in parity_cases():
        fl = FLConfig(**kw)
        diffs, tol, _ = _parity(
            label, lambda d: FederatedSimulation(fl, ds, device=d),
            device, reference)
        report[label] = {"max_abs_diff_per_event": diffs, "tol": tol}
    return report


# HFL with a Gaussian attacker against the trimmed mean at 4 clients in 2
# groups: each group's f clamps to 0, so the noisy upload (scale 0.5)
# enters the group model and round 2 trains from it. From there a float
# rounding can tip round 2 into one of two outcomes 3e-4 to 3e-3 apart:
# on the CPU the port's two engines differ by 2.5e-3 after 2 rounds, and
# one ulp on one initial weight moves the reference's own vectorized run
# by 8.9e-4 (tests/torch_reference_probe.py hfl4). The readings are
# printed; the gates are the bitwise repeat and the group models after
# event 0 (the defended tier-1 aggregate, before any training from noisy
# weights) at 1e-4.
HFL4 = dict(PARITY_CFG, participation=1.0, strategy="hfl", attack="gauss",
            attack_scale=0.5, defense="trimmed_mean")


def hfl4_phase(device="cuda", reference="cpu"):
    import numpy as np
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.tree import tree_leaves

    ds = mnist_like(seed=0, n_train=512, n_test=128)
    runs = [(d, e) for d in (device, reference)
            for e in ("loop", "vectorized")]
    models = {}
    for d, engine in runs + [(device, "loop"), (device, "vectorized")]:
        sim = FederatedSimulation(FLConfig(**HFL4, engine=engine), ds,
                                  device=d)
        st = sim.strategy.init_state(sim)
        for ev in range(HFL4["rounds"]):
            st, _, _ = sim.strategy.run_event(sim, st, ev)
            leaves = {"round": [x.cpu().double().numpy() for x in
                                tree_leaves(sim.strategy.round_model(st))],
                      "groups": [x.cpu().double().numpy() for x in
                                 tree_leaves(st["groups"])]}
            if (d, engine, ev) in models:         # the repeat on `device`
                if not all(np.array_equal(x, y) for k in leaves for x, y in
                           zip(leaves[k], models[(d, engine, ev)][k])):
                    raise SystemExit(f"hfl4 {engine} event {ev}: two runs "
                                     f"of one seed on {device} differ")
            else:
                models[(d, engine, ev)] = leaves

    def dist(a, b, ev, key):
        return max(float(np.abs(x - y).max()) for x, y in
                   zip(models[a + (ev,)][key], models[b + (ev,)][key]))

    report = {}
    for i, a in enumerate(runs):
        for b in runs[i + 1:]:
            label = f"{' '.join(a)} vs {' '.join(b)}"
            report[label] = {k: [dist(a, b, ev, k)
                                 for ev in range(HFL4["rounds"])]
                             for k in ("round", "groups")}
            print(f"  {label}: max |a - b| per event, round model "
                  f"{report[label]['round']}, group models "
                  f"{report[label]['groups']}", flush=True)
    for engine in ("loop", "vectorized"):
        d0 = dist((device, engine), (reference, engine), 0, "groups")
        if d0 > 1e-4:
            raise SystemExit(f"hfl4 {engine}: group models after event 0, "
                             f"{device} vs {reference}, differ by {d0}")
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


def _reset_launches():
    from repro_torch.kernels import fedavg_agg as fa
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import robust_agg as ra
    fa.launches = ra.launches = gm.launches = 0


def study_phase(device="cuda", scale="quick"):
    from repro_torch import paper_study
    from repro_torch.kernels import fedavg_agg as fa

    _reset_launches()                    # the main path's count starts here
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


# -- phase 6 -----------------------------------------------------------------

ADV_COVERAGE = ("attack-gauss-hfl-krum-vec", "attack-replace-cfl-clip-vec",
                "attack-labelflip-afl-trimmed-loop",
                "attack-signflip-gossip-median-vec", "fedprox-dirichlet-vec",
                "fedprox-iid-loop", "fedavgm-iid-vec", "fedadam-iid-vec",
                "fedadam-signflip-median-vec")
RECOVERY_FLOOR = 0.90       # the reference's acceptance threshold
ATTACK_BITES = 0.5          # undefended FedAvg must fall below this share


def _uses_trimmed_kernel(spec):
    """Median / trimmed-mean aggregation events run `trimmed_mean_agg`;
    defended ring gossip sorts its neighborhoods with `torch.sort`
    instead, as the reference sorts them with `jnp.sort`."""
    return (spec.defense in ("median", "trimmed_mean")
            and spec.topology != "ring")


def adversarial_phase(device="cuda"):
    from repro_torch.core import scenarios
    from repro_torch.kernels import fedavg_agg as fa
    from repro_torch.kernels import robust_agg as ra

    names = scenarios.ACCEPTANCE_FAMILY + ADV_COVERAGE
    _reset_launches()                    # the main path's count starts here
    t0 = time.perf_counter()
    results = {}
    for name in names:
        t1 = time.perf_counter()
        results[name] = r = scenarios.run(name, device=device)
        print(f"  {name}: test_acc={r.test_accuracy:.4f} f1={r.f1:.4f} "
              f"build={r.build_time_s:.3f}s "
              f"launches={r.extra['kernel_launches']} "
              f"({time.perf_counter() - t1:.1f}s)", flush=True)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    launches = {"fedavg_agg": fa.launches, "trimmed_mean_agg": ra.launches}
    seconds = time.perf_counter() - t0
    out = {"seconds": seconds, "launches": launches, "runs": []}
    for name, r in results.items():
        spec = scenarios.get(name)
        values = ([getattr(r, k) for k in _METRICS] + list(r.round_train_acc)
                  + list(r.round_train_loss) + list(r.round_test_acc))
        if not all(math.isfinite(v) for v in values):
            raise SystemExit(f"{name}: non-finite metric")
        n_b2 = r.extra["kernel_launches"]["trimmed_mean_agg"]
        if device == "cuda" and _uses_trimmed_kernel(spec) and n_b2 == 0:
            raise SystemExit(f"{name}: trimmed_mean_agg never launched")
        out["runs"].append(dict(r.row(), scenario=name,
                                kernel_launches=r.extra["kernel_launches"],
                                warmup_time_s=r.warmup_time_s,
                                round_test_acc=r.round_test_acc))
    base = results["attack-none-32c-vec"].f1
    ratios = {n: results[n].f1 / base for n in scenarios.ACCEPTANCE_FAMILY}
    out["f1_over_no_attack"] = ratios
    print(f"  macro-F1 over the no-attack run ({base:.4f}): "
          + ", ".join(f"{n}={v:.3f}" for n, v in ratios.items()))
    for n in ("attack-signflip-median-32c-vec",
              "attack-signflip-trimmed-32c-vec"):
        if ratios[n] < RECOVERY_FLOOR:
            raise SystemExit(f"{n} recovers {ratios[n]:.3f} of the "
                             f"no-attack macro-F1, below {RECOVERY_FLOOR}")
    if ratios["attack-signflip-fedavg-32c-vec"] > ATTACK_BITES:
        raise SystemExit("plain FedAvg under sign-flip kept more than half "
                         "the no-attack macro-F1: the attack did not bite")
    if device == "cuda" and launches["trimmed_mean_agg"] == 0:
        raise SystemExit("adversarial path: trimmed_mean_agg was launched "
                         "no time")
    print(f"  adversarial path: launches {launches} in {seconds:.1f}s",
          flush=True)
    return out


# -- phase 7 -----------------------------------------------------------------

def _gossip_bound(C, N, itemsize):
    """Least time for the work: x read once, mix read once, the (C, N)
    output written once; 2*C*C*N float32 operations."""
    t_bytes = (2 * C * N * itemsize + C * C * 4) / H100_BYTES_PER_S
    t_ops = 2 * C * C * N / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _schedule_mix(C, mtd, degree, rounds, event, seed=0):
    """(mix, alive) of one event of a real 30%-churn fault schedule over C
    clients (dead rows are identity rows)."""
    from repro_torch.core import faults
    sched = faults.FaultSchedule(
        profile="churn", seed=seed, num_clients=C, n_events=rounds,
        churn_rate=0.3, quorum_frac=0.5, heartbeat_timeout=1, mtd=mtd,
        event_size=C, gossip_degree=degree)
    return sched.gossip_mix(event, range(C)), sched.alive[event]


# (C, N, label, schedule): `churn-afl-gossip-mtd`'s event 1 (8 clients,
# degree 2, 2 of them dead) and event 0 of the 32-client churn study's
# schedule (degree 4, 9 dead), with and without the moving-target ring
GOSSIP_MAIN = [(8, 7900, "afl-gossip-mtd", (True, 2, 2, 1)),
               (32, 7900, "churn32-mtd", (True, 4, 10, 0)),
               (32, 7900, "churn32-static", (False, 4, 10, 0))]
GOSSIP_EDGE = [(1, 7900), (2, 37), (5, 4097), (33, 4097), (256, 7900),
               (1024, 300), (16, 1 << 20)]


def _gossip_rows():
    import numpy as np
    import torch
    from repro_torch.kernels import gossip_mix as gm

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    gen = torch.Generator().manual_seed(2)
    cases = []
    for C, N, label, (mtd, degree, rounds, ev) in GOSSIP_MAIN:
        mix, alive = _schedule_mix(C, mtd, degree, rounds, ev)
        cases.append((C, N, torch.float32, mix, alive, label, True))
    for C, N in GOSSIP_EDGE:
        degree = 4 if C > 4 else 2
        mix, alive = _schedule_mix(C, False, degree, 3, 1, seed=C)
        cases.append((C, N, torch.float32, mix, alive, "", False))
    mix, alive = _schedule_mix(32, True, 4, 10, 0)
    cases.append((32, 7900, torch.bfloat16, mix, alive, "churn32-mtd", False))
    rows = []
    for C, N, dtype, mix_np, alive, label, main in cases:
        x = torch.randn((C, N), generator=gen).to("cuda", dtype)
        mix = torch.as_tensor(mix_np, device="cuda")
        before = gm.launches
        out = gm.gossip_mix_agg(x, mix)
        torch.cuda.synchronize()
        if gm.launches != before + 1:
            raise SystemExit("gossip_mix_agg: the wrapper did not launch")
        exp = gm.gossip_mix_torch(x, mix)
        err = float((out.float() - exp.float()).abs().max())
        tol = 1e-6 if dtype == torch.float32 else 2e-2
        within = bool(((out.float() - exp.float()).abs()
                       <= tol + tol * exp.float().abs()).all())
        dead = torch.as_tensor(np.flatnonzero(~alive), device="cuda")
        identity = bool(torch.equal(out[dead], x[dead]))
        row = {"C": C, "N": N, "schedule": label,
               "dtype": str(dtype).replace("torch.", ""),
               "dead_rows": int(dead.numel()), "max_abs_err": err,
               "tol": tol, "identity_rows_bitwise": identity}
        if not (out.dtype == dtype and out.shape == (C, N) and within
                and identity):
            raise SystemExit(f"gossip_mix_agg disagrees with its plain "
                             f"version: {row}")
        if main:
            fns = {"": lambda: gm.gossip_mix_agg(x, mix),
                   "plain_": lambda: gm.gossip_mix_torch(x, mix),
                   "library_": lambda: mix @ x}           # yardstick only
            for key, fn in fns.items():
                row[f"{key}ms"] = _time_ms(fn)
                row[f"{key}graph_ms"] = _graph_ms(fn)
            row["bound_ms"], row["bound_by"] = _gossip_bound(
                C, N, x.element_size())
        print("  gossip_mix_agg", json.dumps(row), flush=True)
        rows.append(row)
    n = gm.MAX_CLIENTS + 1
    try:
        gm.gossip_mix_agg(torch.zeros((n, 8), device="cuda"),
                          torch.eye(n, device="cuda"))
    except ValueError:
        pass
    else:
        raise SystemExit(f"gossip_mix_agg took C = {n}, above its stated "
                         f"maximum")
    return rows


def churn_parity_specs():
    """(label, ScenarioSpec) of every card-vs-CPU run under faults, each
    under both engines: the registered `churn-afl-gossip-mtd` (masked mix
    with the moving-target ring; the fused engine it names stands for
    loop == vectorized, bitwise in the reference) and `churn-hfl-quorum`
    (group and round quorum holds), AFL star with median under churn
    (`trimmed_mean_agg` on masked rows), CFL under `mid` (dead visitors'
    merges discarded), FedAvgM under `mid` at quorum 0.6 over 6 rounds
    (events 4 and 5 hold the server optimizer), and FedProx and FedAdam
    under `mid`. FedAdam's distance is printed, not gated: Adam divides
    by sqrt(v) + eps, so a pseudo-gradient component of one ulp of a
    weight (~1e-8, the size of eps) moves its step by a sizable share of
    lr, and card and CPU differ by such ulps. Its bitwise repeat on the
    card is gated."""
    from repro_torch.core import scenarios as sc
    base = {
        "churn-afl-gossip-mtd": sc.get("churn-afl-gossip-mtd"),
        "churn-hfl-quorum": sc.get("churn-hfl-quorum"),
        "afl-star-churn-median": sc.ScenarioSpec(
            "afl-star-churn-median", "AFL star, sign-flip against the "
            "median under 30% churn", strategy="afl", topology="star",
            participation=1.0, attack="sign_flip", attack_scale=2.0,
            defense="median", fault_profile="churn", churn_rate=0.3),
        "cfl-mid": sc.ScenarioSpec(
            "cfl-mid", "sequential CFL under mid-severity faults",
            strategy="cfl", topology="sequential", fault_profile="mid"),
        "fedavgm-mid-quorum": dataclasses.replace(
            sc.get("fedavgm-iid-vec"), fault_profile="mid",
            quorum_frac=0.6, rounds=6),
        "fedprox-mid": dataclasses.replace(
            sc.get("fedprox-iid-loop"), fault_profile="mid"),
        "fedadam-median-mid": dataclasses.replace(
            sc.get("fedadam-signflip-median-vec"), fault_profile="mid"),
    }
    return [(f"{name}/{engine}", dataclasses.replace(spec, engine=engine))
            for name, spec in base.items()
            for engine in ("loop", "vectorized")]


def churn_parity_phase(device="cuda", reference="cpu"):
    from repro_torch.core import scenarios

    report = {}
    for label, spec in churn_parity_specs():
        diffs, tol, sims = _parity(
            label, lambda d: scenarios.resolve(spec, d), device, reference,
            gated=spec.strategy != "fedadam")
        holds = sorted(ev for ev, fe in sims[0]._fault_log.items()
                       if not fe.qok)
        if label.startswith("fedavgm") and not holds:
            raise SystemExit(f"parity {label}: no quorum hold happened")
        report[label] = {"max_abs_diff_per_event": diffs, "tol": tol,
                         "gated": spec.strategy != "fedadam",
                         "quorum_held_events": holds}
        print(f"    quorum holds at events {holds}", flush=True)
    return report


CHURN_ARMS = ("churn-signflip-median-mtd", "churn-signflip-median-static")
CLEAN_TWIN = "churn-clean-mtd"
# The MTD margin (mtd macro-F1 - static macro-F1) is printed, not gated:
# see PERF.md section 7 for the CPU rehearsals behind that choice.
CHURN_MARGIN_GATED = False


def churn_phase(device="cuda"):
    import torch
    from repro_torch.core import scenarios
    from repro_torch.kernels import fedavg_agg as fa
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import robust_agg as ra

    recorded = {d["scenario"]: d["faults"] for d in json.loads(
        (ROOT / "experiments" / "churn" / "churn_mtd_32c.json").read_text())}
    specs = {n: scenarios.get(n) for n in CHURN_ARMS}
    specs[CLEAN_TWIN] = dataclasses.replace(
        specs[CHURN_ARMS[0]], name=CLEAN_TWIN, attack="none",
        defense="none")
    expected = {CHURN_ARMS[0]: recorded[CHURN_ARMS[0]],
                CHURN_ARMS[1]: recorded[CHURN_ARMS[1]],
                CLEAN_TWIN: recorded[CHURN_ARMS[0]]}  # the same schedule

    _reset_launches()                    # the main path's count starts here
    t0 = time.perf_counter()
    results = {}
    for name, spec in specs.items():
        t1 = time.perf_counter()
        results[name] = r = scenarios.run(spec, device=device)
        print(f"  {name}: test_acc={r.test_accuracy:.4f} f1={r.f1:.4f} "
              f"build={r.build_time_s:.3f}s "
              f"launches={r.extra['kernel_launches']} "
              f"({time.perf_counter() - t1:.1f}s)", flush=True)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {"fedavg_agg": fa.launches, "trimmed_mean_agg": ra.launches,
                "gossip_mix_agg": gm.launches}
    seconds = time.perf_counter() - t0
    out = {"seconds": seconds, "launches": launches, "runs": []}
    for name, r in results.items():
        spec = specs[name]
        values = ([getattr(r, k) for k in _METRICS] + list(r.round_train_acc)
                  + list(r.round_train_loss) + list(r.round_test_acc))
        if not all(math.isfinite(v) for v in values):
            raise SystemExit(f"{name}: non-finite metric")
        if r.extra["faults"] != expected[name]:
            raise SystemExit(f"{name}: faults block {r.extra['faults']} "
                             f"differs from the reference's recorded "
                             f"{expected[name]}")
        n_b3 = r.extra["kernel_launches"]["gossip_mix_agg"]
        dispatched = r.extra["telemetry"]["dispatch"].get(
            "kernel.gossip_mix", 0)
        if spec.defense == "none" and dispatched == 0:
            raise SystemExit(f"{name}: no masked-mix event")
        if device == "cuda" and n_b3 != dispatched:
            raise SystemExit(f"{name}: gossip_mix_agg launched {n_b3} times "
                             f"for {dispatched} masked-mix events")
        if spec.defense != "none" and n_b3:
            raise SystemExit(f"{name}: a defended ring launched "
                             f"gossip_mix_agg")
        out["runs"].append(dict(r.row(), scenario=name,
                                kernel_launches=r.extra["kernel_launches"],
                                faults=r.extra["faults"],
                                warmup_time_s=r.warmup_time_s,
                                round_test_acc=r.round_test_acc,
                                round_train_loss=r.round_train_loss))
    f1 = {n: results[n].f1 for n in CHURN_ARMS}
    margin = f1[CHURN_ARMS[0]] - f1[CHURN_ARMS[1]]
    out["mtd_margin"] = margin
    print(f"  macro-F1: MTD {f1[CHURN_ARMS[0]]:.4f}, static "
          f"{f1[CHURN_ARMS[1]]:.4f}, margin {margin:+.4f} (reference "
          f"recorded +0.21; the reference's CI floor on the MTD arm 0.2)",
          flush=True)
    if CHURN_MARGIN_GATED and margin <= 0:
        raise SystemExit(f"MTD margin {margin} is not positive")
    if device == "cuda" and launches["gossip_mix_agg"] == 0:
        raise SystemExit("churn path: gossip_mix_agg was launched no time")
    print(f"  churn path: launches {launches} in {seconds:.1f}s", flush=True)
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
    parity["hfl-gauss-trimmed-4c"] = hfl4_phase("cuda", "cpu")
    _phase("study (slice 1 main path)")
    study = study_phase("cuda", "quick")
    _phase("adversarial study (slice 2 main path)")
    adversarial = adversarial_phase("cuda")
    _phase("churn (slice 3 main path)")
    print("  -- (a) gossip_mix_agg against its plain version", flush=True)
    kernels["gossip_mix_agg"] = _gossip_rows()
    print("  -- (b) card against CPU under faults", flush=True)
    parity["churn"] = churn_parity_phase("cuda", "cpu")
    print("  -- (c) the churn study", flush=True)
    churn = churn_phase("cuda")

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
    trows = kernels["trimmed_mean_agg"]
    trep = next(r for r in trows
                if (r["C"], r["N"], r["trim"]) == (32, 7900, 8))
    tentry = {
        "name": "trimmed_mean_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trimmed_mean_agg.cu",
        "replaces": "src/repro/kernels/robust_agg.py:190",
        "launches": adversarial["launches"]["trimmed_mean_agg"],
        "max_abs_err": max(r["max_abs_err"] for r in trows),
        "ms": trep["ms"], "plain_ms": trep["plain_ms"],
        "bound_ms": trep["bound_ms"], "bound_by": trep["bound_by"],
        "library_ms": None, "sort_ms": trep["sort_ms"],
        "shape": [32, 7900], "trim": 8,
        "shapes": [r for r in trows if "ms" in r]}
    grows = kernels["gossip_mix_agg"]
    grep = next(r for r in grows if r["schedule"] == "churn32-mtd"
                and "ms" in r)
    gentry = {
        "name": "gossip_mix_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix.py:59",
        "launches": churn["launches"]["gossip_mix_agg"],
        "max_abs_err": max(r["max_abs_err"] for r in grows),
        "ms": grep["ms"], "plain_ms": grep["plain_ms"],
        "bound_ms": grep["bound_ms"], "bound_by": grep["bound_by"],
        "library_ms": grep["library_ms"], "shape": [32, 7900],
        "shapes": [r for r in grows if "ms" in r]}
    for e in (entry, tentry):
        e["launches_churn"] = churn["launches"][e["name"]]
    doc = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "build_s": build_s,
           "kernels": kernels, "parity": parity, "study": study,
           "adversarial": adversarial, "churn": churn}
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
        "launches": entry["launches"]} for r in entry["shapes"]]
        + [{"name": "trimmed_mean_agg", "replaces": tentry["replaces"],
            "C": r["C"], "N": r["N"], "trim": r["trim"],
            "max_err": r["max_abs_err"], "kernel_us": r["ms"] * 1e3,
            "plain_us": r["plain_ms"] * 1e3, "sort_us": r["sort_ms"] * 1e3,
            "bound_us": r["bound_ms"] * 1e3,
            "kernel_graph_us": r["graph_ms"] * 1e3,
            "plain_graph_us": r["plain_graph_ms"] * 1e3,
            "sort_graph_us": r["sort_graph_ms"] * 1e3,
            "launches": tentry["launches"]} for r in tentry["shapes"]]
        + [{"name": "gossip_mix_agg", "replaces": gentry["replaces"],
            "C": r["C"], "N": r["N"], "schedule": r["schedule"],
            "max_err": r["max_abs_err"], "kernel_us": r["ms"] * 1e3,
            "plain_us": r["plain_ms"] * 1e3,
            "library_us": r["library_ms"] * 1e3,
            "bound_us": r["bound_ms"] * 1e3,
            "kernel_graph_us": r["graph_ms"] * 1e3,
            "plain_graph_us": r["plain_graph_ms"] * 1e3,
            "library_graph_us": r["library_graph_ms"] * 1e3,
            "launches": gentry["launches"]} for r in gentry["shapes"]]))
    print(card)
    print(json.dumps({"kernels": [entry, tentry, gentry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
