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
   (`w @ x`; `torch.quantile` for the median; timed only, the port never
   calls it) and the bound of the card (bytes or operations over the
   H100's peak rates), with the share of the bound it reaches, which
   must not pass 1 (and, on the progress lines only, the first port's
   graph time beside it for reading);
   `fedavg_agg`'s 32-client call must repeat bitwise;
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
   the other kernels beside `mix @ x` at C = 8 and C = 32; (b) the port on the card against the port on the
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
   defended run;
8. upload transport (slice 4 main path) — (a) `dequant_agg` through the
   port's twin of the reference's `measure_comm` (C = 8, 32, 64) and on
   real payloads (the port's qsgd encoding of the 32 trained uploads of
   event 0 of `comm-qsgd-accept-32c-vec`), where it must agree with
   `fedavg_agg` over the decoded matrix; then against its plain version
   at main and edge shapes (C up to 12288, unaligned N), with the
   design's name, a bitwise repeat at C = 32, timed as the other kernels
   beside `sw @ q.float()` (a cast plus a GEMV: no single PyTorch call
   takes int8 input) with the share of its bound, and at the (16, 2^20)
   edge, where bytes decide the time, with its streaming rate; (b) the port on the card against the port on the CPU
   with a codec on the wire and under the async runtime (8 configurations
   x 2 engines), event by event, with a bitwise repeat on the card and
   the codec payloads of event 0 re-encoded on the CPU from the card's
   inputs bitwise; (c) the codec and async scenarios through the
   scenario runner. Fails on a non-finite metric, a `communication`
   block of the qsgd acceptance run that differs from the reference's
   recorded one (experiments/comm/acceptance.json), a `communication`
   block on its dense twin, a top-k compression ratio other than the
   analytic one, `fedavg_agg` launched no time in an async run, or
   `dequant_agg` launched in any codec run (the round path decodes, then
   aggregates through `fedavg_agg`, as in the reference).

9. model zoo serving (slice 5 main path) — (a) `flash_attention` and
   `ssm_scan` against their plain versions on the card at the main
   path's shapes (zamba2-1.2b's shared block and Mamba2 scan at B = 2,
   S = 4096; yi-9b's grouped heads at S = 2048) in bfloat16 (B5 on the
   tensor cores) and float32 (B5 in 3xTF32 on the tensor cores), and at
   edge shapes (a window, no mask, T != S, S = 128, d = 256 in both
   types; d = 80, d = 48, d = 192, d = 160 and S = 192 with 8 query heads
   per key/value head in bfloat16; one chunk, S below the chunk) and at
   phase 12's phi-3-vision shape (32 heads of 96, S = 2048), timed
   beside the plain
   version and, for `flash_attention`, `scaled_dot_product_attention`
   (timed only), with the occupancy of each (B6: its three passes,
   `ssd_chunk_state`, `ssd_state_pass`, `ssd_chunk_scan`, in both types),
   B5's TFLOP/s and share of its bound (and, on the progress lines only,
   the first port's graph time); B6's states entering every chunk, as its
   first two passes leave them, against the plain rendering of its passes
   (`ssm_scan_passes_torch`) at the mid edge shape; shapes off each
   kernel's envelope must raise before any launch; (b) zamba2 reduced to 4 layers
   on the card against the CPU (the flash prefill, the kernel prefill,
   8 decode steps; 1e-4) with a bitwise repeat; (c) zamba2-1.2b at full
   width and depth, random weights from a seed: the plain, flash and kernel
   prefills (`make_prefill_step`; every mamba layer through
   `mamba2_forward(use_kernel=True)`) in float32 (gated) and bfloat16
   (printed), 64 teacher-forced decode steps against the prefill (5e-2),
   `make_decode_dispatch` on 4 requests and a greedy generation repeated
   bitwise, with prefill and decode times and the peak memory; (d) yi-9b
   at full width, 4 of its 48 layers, the flash prefill against einsum.
   Fails on a kernel disagreeing with its plain version, a prefill off
   the plain one, or a launch count other than 6 flash / 38 scan per
   zamba2 prefill and 4 flash in the yi-9b prefill.

10. result documents (the scenario runner) — the 7 loop and vectorized
   registrations of the reference's baseline grid (`iid-hfl-vec`,
   `iid-hfl-loop`, `iid-afl-vec`, `iid-cfl-vec`, `ring-gossip-vec`,
   `dirichlet-hfl-loop`, `dirichlet-afl-loop`; 8 clients, 2 rounds)
   through `scenarios.run_scenario` on the card, printing each run's
   metrics and rounds per second. Fails on a document whose keys or
   blocks differ from schema v2.5, one that does not come back unchanged
   through `json` and the port's `load_result`, a non-finite metric, or
   `fedavg_agg` launched no time in a run.

11. fused executor and serving — (a) the reference's fused-parity
   configurations (tests/test_fused.py: HFL over 3 rounds, AFL at
   participation 0.5, CFL, FedProx, FedAvgM, FedAdam, AFL gossip, AFL
   sign-flip against the median; 8 clients, the paper CNN at full width)
   and the `churn-afl-gossip-mtd` and `comm-qsgd-hfl-fused`
   configurations, each run four times: vectorized, fused (one CUDA graph
   of a round, replayed) and the fused eager loop on the card, and fused
   on the CPU. Fails unless the graph run is within the reference's fused
   tolerances of the vectorized run (round accuracies 1e-5, losses 1e-4,
   final metrics 1e-5, confusion equal), equals the eager run bit for bit,
   and holds to the CPU at phase 4's tolerances (FedAdam and the codec
   run printed); a profile of each fused run's build window counts the
   round kernels on the device, and the graph run's replays must launch
   what the eager rounds launch, with no wrapper called in its window;
   (b) the 4 fused registrations through the scenario runner,
   schema-checked as in phase 10, with `fedavg_agg` launched inside the
   replayed graph (so counted by the profile of the build window) in
   every run but the median one, `trimmed_mean_agg` in the median run,
   `gossip_mix_agg` in the churn-gossip run and `dequant_agg` in none;
   (c) the 3 serving registrations and the trace demo: every request
   completed or shed, `serve-iid-fused`'s serving block byte for byte its
   vectorized twin's, the trace valid; (d) rounds per second of the fused
   graph, the fused eager loop and the vectorized engine for
   `iid-hfl-fused` (2 rounds and 20), and an AFL star at 64 clients: the
   median and range of 5 interleaved runs each, with the device idle
   share of one profiled run (printed, not gated).

12. model zoo, rest (slice 11) — (a) the five configs slice 11 ports, at
   their published widths with random weights from a seed, each freed
   before the next: qwen3-moe-30b-a3b (4 of 48 layers; B = 1, S = 2048;
   MoE with 128 experts, top 8), deepseek-v2-lite-16b (4 of 27; MLA and
   MoE with 2 shared experts), xlstm-125m (all 12 layers, sLSTM at 3, 7,
   11; B = 2, S = 2048), seamless-m4t-large-v2 (24 encoder + 24 decoder
   layers; 1024 frames, S = 1024) and phi-3-vision-4.2b (8 of 32 layers;
   576 patches + 1472 tokens). Each runs the plain (einsum) prefill in
   float32 and the bfloat16 prefill (printed against it); qwen3-moe and
   phi-3-vision also the float32 flash prefill, gated against einsum at
   1e-3 of max |logits| with `flash_attention` launched once a layer;
   64 teacher-forced decode steps gated at 5e-2 against a 64-token
   prefill (MoE drop-free, capacity_factor = num_experts) for qwen3-moe,
   deepseek and xlstm, timed for seamless (zero cross-attention K/V) and
   phi-3-vision (no patch prefix), as in the reference; parameter count,
   prefill ms and tokens/s, decode ms/step, peak memory and the device
   busy / idle share of one bfloat16 prefill. (b) the five reduced on the
   card against the CPU (MoE at its default capacity factor, so with
   drops; xlstm with an sLSTM; seamless with its encoder; phi-3-vision
   with its prefix): the flash prefill and 8 decode steps within 1e-4,
   with a bitwise repeat. Phase 9(a) times B5 at phi-3-vision's shape
   (32 heads of 96, S = 2048) in both types. Fails on a config that does
   not build, non-finite logits, a gate missed or a launch count other
   than one B5 a layer in the flash prefills and none elsewhere.

13. training (slice 12) — (a) zamba2-1.2b at full width, depth cut
   38 -> 7 (printed) so the shared block runs once at its published
   cadence, float32, B = 2, S = 256: one `make_train_step` with SGD
   (lr 1e-2) and one with AdamW on the card against the CPU from one init
   (loss and grad-norm within 1e-5 relative; SGD's parameters within
   1e-6, AdamW's printed), the SGD step repeated bitwise on the card,
   and on the card grad_accum = 2 against 1 and remat off against on at
   the same tolerances; (b) zamba2-1.2b whole (1,104,777,344 parameters,
   bfloat16 activations, float32 parameters, remat) on MarkovLM batches
   of 4 x 2048 with grad_accum = 2 and AdamW (3e-4, weight decay 0.01,
   clip 1.0): a warm-up and 4 timed steps on fresh batches, then 6 on one
   repeated batch; ms per step (median and range), tokens/s, MFU (6 N D
   over the step and the bf16 peak, `launch/roofline.py`), peak memory
   and the device busy / idle share of the first repeated step, profiled; (c) the
   federated trainer: phi3-mini reduced (float32; 4 clients in 2 groups,
   K = 2) one round of HFL, AFL, AFL gossip and CFL on the card against
   the CPU (1e-4) with a bitwise repeat, then xlstm-125m whole with 4
   clients, K = 2 steps of 2 x 256 tokens, 2 rounds of HFL, AFL (client 0
   alone in the second) and CFL, with seconds per round and peak memory. Fails
   on a gate missed, a non-finite loss, grad-norm or parameter, the
   repeated batch's loss not falling, clients apart after an HFL or AFL
   round (or together after CFL's), or any kernel launched: training
   runs the plain paths, as in the reference (B5 and B6 raise under
   autograd).

14. mesh (slice 13) — (a) every mesh operator of `core/aggregation.py`
   (`mesh_fedavg_stacked`, `mesh_gossip_stacked`, `mesh_hfl_stacked` with
   groups that nest in, equal and span shards, each with and without the
   one-hot fallback, `hfl_tier1_local`, `mesh_hfl` single-pod and on a
   2 x 2 pod world, `mesh_afl_gossip`, `mesh_afl_fedavg`, `mesh_cfl`) on 4
   ranks sharing the card (gloo over CUDA tensors) at the paper CNN's
   width, against the host aggregate on the card (error below 1e-4, ranks
   within 1e-5), HFL's tier 1 issuing no collective on any rank; (b) the
   7 mesh preconditions raising before any rank starts, then the
   reference's 5 mesh-parity configurations and HFL under churn at 16
   clients on 8 ranks sharing the card (gloo, eager rounds) against the
   single-device fused graph run trained in stacks of the ranks' size and
   against the unchunked one (round accuracy 1e-5, loss 1e-4, test
   accuracy and final metrics 1e-5; AFL star, AFL gossip and AFL chunked
   miss the unchunked gate on the card and print that gap: ROADMAP §C.4),
   no hand kernel launched in any
   rank, the HFL run repeated bitwise, tier 1 without a collective on
   every rank; (c) nccl at world 1, the round captured as a CUDA graph,
   within 1e-5 of the single-device graph run on every metric and
   repeated bitwise; (d) 1024 clients, fused_chunk=32, AFL star, 2 rounds
   on the 8 ranks against the single-device chunked graph run, with
   seconds per round beside it and each rank's peak memory (the ranks
   share one card: not a speedup). Every run prints its backend and its
   form (graph or eager).
15. the zoo's sharded steps (slice 14) — on 8 ranks sharing the card
   (gloo), laid out (data 4, model 2), each holding the reference's shard
   of every leaf (`launch/train.py`, `core/trainer.py`,
   `launch/serve.py`; rank halves in tests/torch_sharded_cases.py): (a)
   zamba2-1.2b at full width cut 38 -> 7 (float32, fsdp, B x S = 8 x
   256) and the reference test's four (arch, profile) pairs reduced
   (phi3-mini tp, qwen3-moe tp, zamba2 fsdp, xlstm dp; 8 x 64): 2 SGD
   steps and 1 AdamW step of `make_sharded_train_step` against
   `make_train_step` on the card (loss and grad-norm within 1e-5
   relative, SGD params within 1e-6, AdamW's printed), the SGD steps
   repeated bitwise, all-gathers issued; (b) the reference's FL-mesh
   config (phi3-mini reduced, vocab 512, 4 clients, 2 groups, K = 2), 2
   rounds of HFL, AFL, AFL gossip and CFL against the one-device
   `FederatedTrainer` (loss and params 1e-5, bitwise repeat, collectives
   in every strategy, gossip's collective-permute); (c) zamba2 cut as in
   (a) under `attn_impl="flash"`: the kernel prefill of 8 x 2048 tokens
   and 16 teacher-forced decode steps against the single-device ones
   (prefill within 1e-3 of max abs(logit), decode 1e-4), B5 and B6
   launched in every rank; (d) the dry-run on the meta device at full
   size: the four FL strategies over phi3-mini on 16x16 and yi-9b's
   decode shapes on 16x16 and 2x16x16 (ok, FLOPs and collectives; the
   whole sweep runs through `python -m repro_torch.launch.dryrun`, PERF.md
   §5). Each rank's peak memory and seconds a step print beside the
   single-device step's; no kernel launches in (a) and (b). The sharded
   steps' weight gathers are gloo all_gathers of host copies (each rank
   sends its shard once);
16. the examples' twins and the graphed decode (slice 15) — (a)
   zamba2-1.2b whole as 9(c) (float32, random weights from seed 0, B =
   2): `launch.serve.make_graphed_serve_step` captures `decode_step` as
   one CUDA graph and replays it; its logits over 64 teacher-forced
   steps equal the eager step's bit for bit (and the state after them),
   stay within 5e-2 of the 64-token prefill, and repeat bitwise in a
   second graphed run; ms a step of the graph and the eager step (median
   of 3 runs of 16 steps), the idle share of one profiled run of each,
   the peak memory; (b) one reduced config per other kind of decode
   state (gemma3 with an 8-slot window ring wrapping over 16 steps,
   deepseek-v2-lite's MLA, qwen3-moe drop-free, xlstm-125m's mLSTM and
   sLSTM): graph == eager bit for bit, logits and state; (c) the twins
   of the reference's examples in-process through `main(argv)` with the
   reference test's arguments: the quickstart on xlstm-125m (the loss
   falls, the checkpoint restores bitwise), the FL twin three ways (afl
   with --curves, fedadam vectorized, afl --gossip --non-iid) and a
   fourth with gossip under `--fault-profile churn` (B1 launched in each;
   B3 in the fourth: it mixes masked gossip, while the static ring mixes
   by one plain matmul, as in the reference) and serve_decode on gemma3-4b reduced
   (its tokens equal an eager `greedy_generate`'s). The multipod demo's
   twin runs on the meta device, as 15(d) does, so it is not run here.

Every phase prints its seconds when it closes (`PHASE_SECONDS` in
chip_smoke.json). Phases 5, 6, 7(c), 8(a), 8(c), 9(c), 9(d), 10,
11(b)-(c), 12(a), 13 and 16 set
every kernel's launch count to 0 just before they start and read the
counts just after; a replayed graph runs no wrapper, so 11(b) also reads the
launches a profile counts on the device. Phase 14's ranks count their own
launches from the start of each run and must launch none: the mesh path,
like the reference's, runs plain torch ops and collectives. Phase 15's
ranks count theirs from the start of each sharded run (a fresh process
each): none in 15(a)-(b), B5 and B6 in every rank in 15(c). 16(c) reads
each FL twin run's launches from `FederatedSimulation._kernel_launches()`.

The last lines are the card's nvidia-smi line, one JSON object
{"kernels": [...]} and the result {"ok": true, "device": {...}}. Full
results also go to chiprun_out/chip_smoke.json.
"""
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores
L2_BYTES = 50 * 2**20            # H100 SXM L2 cache


PHASE_SECONDS = {}        # phase -> seconds, as `_phase` closes each


def _phase(name=None):
    """Close the running phase, printing its seconds, and open `name`
    (None: close only)."""
    now = time.perf_counter()
    if _OPEN:
        prev, t0 = _OPEN.pop()
        PHASE_SECONDS[prev] = now - t0
        print(f"  [phase {prev!r} took {now - t0:.1f}s]", flush=True)
    if name is not None:
        _OPEN.append((name, now))
        print(f"\n== {name}", flush=True)


_OPEN = []


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


def _share(row):
    """The share of the bound a timed row reaches in a CUDA graph. A bound
    is the least time the card could take: a kernel that beats it means
    the bound is wrong, and the run fails."""
    share = row["bound_ms"] / row["graph_ms"]
    if share > 1:
        raise SystemExit(f"a kernel beat its bound: {row}")
    return share


# CFL merge, HFL/AFL at 4 and 8 clients, the 32-client adversarial family
MAIN_SHAPES = [(2, 7900), (4, 7900), (8, 7900), (32, 7900)]
# then the edges; C > 4 splits the loads over warps (float4 at N = 7900,
# scalar at N = 7901, rows past a multiple of 8 at 33)
EDGE_SHAPES = [(1, 1), (3, 37), (5, 4097), (16, 1 << 20), (33, 7900),
               (64, 7900), (32, 7901), (33, 7901), (64, 7901)]
# the first port's graph times in us, before the redesign (PERF.md section
# 6), printed on the progress lines beside this run's for reading only: not
# a gate, and not in the kernels line
FIRST_PORT_FEDAVG_GRAPH_US = {2: 1.488, 4: 1.725, 8: 1.989, 32: 3.588}


def kernel_phase():
    return {"fedavg_agg": _fedavg_rows(),
            "trimmed_mean_agg": _trimmed_rows()}


def _fedavg_rows():
    import torch

    gen = torch.Generator().manual_seed(0)
    cases = ([(C, N, torch.float32, True) for C, N in MAIN_SHAPES]
             + [(C, N, torch.float32, False) for C, N in EDGE_SHAPES]
             + [(4, 5000, torch.bfloat16, False),
                (32, 7900, torch.bfloat16, False)])
    rows = []
    for C, N, dtype, main in cases:
        row = fedavg_row(C, N, dtype, main, gen)
        first = ({"first_port_graph_us": FIRST_PORT_FEDAVG_GRAPH_US[C]}
                 if main else {})
        print("  fedavg_agg", json.dumps({**row, **first}), flush=True)
        rows.append(row)
    return rows


def fedavg_row(C, N, dtype, main, gen):
    """`fedavg_agg` at (C, N) against its plain version; on a main shape
    also timed beside the plain version and `w @ x`, with its bound."""
    import torch
    from repro_torch.kernels import fedavg_agg as fa

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
        row["bound_share"] = _share(row)
    if (C, N, dtype) == (32, 7900, torch.float32):
        # the rows are added in one fixed order
        row["bitwise_repeat"] = all(
            torch.equal(fa.fedavg_agg(x, w), out) for _ in range(3))
        if not row["bitwise_repeat"]:
            raise SystemExit(f"fedavg_agg is not bitwise repeatable: {row}")
    return row


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
             (48, 4097, 23), (64, 7900, 16), (65, 7900, 16),
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


def trimmed_row(x, trim, main, kind=""):
    """`trimmed_mean_agg` on the card tensor x against its plain version
    (NaN and inf where the plain version has them); on a main shape also
    timed beside the plain version, its `torch.sort` step and, for the
    median, `torch.quantile`, with its bound and a digest of its output's
    bits."""
    import hashlib

    import torch
    from repro_torch.kernels import robust_agg as ra

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
               # a step of the plain version, timed for reading
               "sort_": lambda: torch.sort(x, dim=0)}
        if trim == (C - 1) // 2:
            # the median: one PyTorch call computes it, the yardstick
            # (timed only: the port never calls it)
            fns["library_"] = lambda: torch.quantile(
                x, 0.5, dim=0, interpolation="midpoint")
        for key, fn in fns.items():
            row[f"{key}ms"] = _time_ms(fn)
            row[f"{key}graph_ms"] = _graph_ms(fn)
        row.setdefault("library_ms", None)
        row["bound_ms"], row["bound_by"] = _trimmed_bound(
            C, N, trim, x.element_size())
        row["bound_share"] = _share(row)
        row["out_sha256"] = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()
    return row


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
        row = trimmed_row(x.cuda(), trim, main, kind)
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


def _parity(label, make_sim, device, reference, gated=True, level=None):
    """Three runs of one config — on `device`, on `reference`, and on
    `device` again — driven event by event. After every event the round
    model (and HFL's group models) of the first must equal the third bit
    for bit and agree with the second within 1e-4 abs and rel; HFL 1e-3,
    because its two-tier schedule amplifies float reassociation in
    near-tied max-pool windows to ~3e-4 after 2 rounds (the reference's
    own two engines differ by as much; tests/test_torch_simulation.py).
    With `gated=False` the distance is printed, not held to the
    tolerance, and the round models must be finite. `level(sim)` (upload
    codecs, phase 8) returns, for the event just run, how far one flipped
    quantization level or one swapped top-k coordinate can move a
    round-model coordinate, and how many uploads were encoded. Every
    coordinate is held to the tolerance above, except that up to
    FLIPS_PER_UPLOAD coordinates per upload so far (twice that under HFL,
    where a moved coordinate shows in the round model and in its group's)
    may exceed it by the levels of the events so far. Returns (max |device - reference| per event, tol,
    the sims, the coordinates beyond tol per event)."""
    import numpy as np
    from repro_torch.tree import tree_leaves

    sims = [make_sim(d) for d in (device, reference, device)]
    tol = 1e-3 if sims[0].fl.strategy == "hfl" else 1e-4
    states = [s.strategy.init_state(s) for s in sims]

    def leaves(s, st):
        out = tree_leaves(s.strategy.round_model(st))
        return out + (tree_leaves(st["groups"]) if "groups" in st else [])

    diffs, beyond, allowance, room = [], [], 0.0, 0
    for ev in range(sims[0].strategy.num_events(sims[0])):
        for i, s in enumerate(sims):
            states[i], _, _ = s.strategy.run_event(s, states[i], ev)
        if level is not None:
            lv, uploads = level(sims[0])
            allowance += lv
            room += FLIPS_PER_UPLOAD * uploads
        a, b, again = (leaves(s, st) for s, st in zip(sims, states))
        if not all(x.equal(y) for x, y in zip(a, again)):
            raise SystemExit(f"parity {label} event {ev}: two runs of "
                             f"one seed on {device} differ")
        copies = 2 if "groups" in states[0] else 1
        diff, n_beyond = 0.0, 0
        for x, y in zip(a, b):
            x = x.cpu().double().numpy()
            y = y.cpu().double().numpy()
            if not (np.isfinite(x).all() and np.isfinite(y).all()):
                raise SystemExit(f"parity {label} event {ev}: non-finite "
                                 f"round model")
            if gated and not np.allclose(x, y, atol=tol + allowance,
                                         rtol=tol):
                raise SystemExit(f"parity {label} event {ev}: {device} "
                                 f"vs {reference} beyond {tol} + "
                                 f"{allowance}")
            diff = max(diff, float(np.abs(x - y).max()))
            n_beyond += int((np.abs(x - y) > tol + tol * np.abs(y)).sum())
        if gated and n_beyond > copies * room:
            raise SystemExit(f"parity {label} event {ev}: {n_beyond} "
                             f"coordinates beyond {tol}, more than the "
                             f"{copies * room} that flipped levels or "
                             f"swapped top-k coordinates can explain")
        diffs.append(diff)
        beyond.append(n_beyond)
    extra = (f"; coordinates beyond tol per event {beyond} (at most "
             f"{copies * room}), allowance {allowance:.3g}"
             if level is not None else "")
    print(f"  {label}: max |{device} - {reference}| per event {diffs} "
          f"({f'tol {tol}' if gated else 'printed, not gated'}{extra})",
          flush=True)
    return diffs, tol, sims, beyond


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
        diffs, tol, _, _ = _parity(
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
    from repro_torch.kernels import comm_agg as ca
    from repro_torch.kernels import fedavg_agg as fa
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import ssm_scan as ss
    fa.launches = ra.launches = gm.launches = ca.launches = 0
    fl.launches = ss.launches = 0


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
    import torch
    from repro_torch.kernels import gossip_mix as gm

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
    for case in cases:
        row = gossip_row(*case, gen)
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


def gossip_row(C, N, dtype, mix_np, alive, label, main, gen):
    """`gossip_mix_agg` at (C, N) with one schedule's mixing matrix
    against its plain version (dead clients' identity rows bit for bit);
    on a main shape also timed beside the plain version and `mix @ x`,
    with its bound and a digest of its output's bits."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch.kernels import gossip_mix as gm

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
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
        row["out_sha256"] = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()
    return row


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
        diffs, tol, sims, _ = _parity(
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


# -- phase 8 -----------------------------------------------------------------

def _dequant_bound(C, N):
    """Least time for the work: the int8 matrix read once, the scales and
    weights read once, the f32 output written once; 2*C*N float32
    operations."""
    t_bytes = (C * N + 4 * N + 8 * C) / H100_BYTES_PER_S
    t_ops = 2 * C * N / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _dequant_err(out, exp, q, s, w):
    """(max |out - exp|, whether every column is within 1e-6 of
    sum_c |s_c w_c q[c, n]|)."""
    import torch
    scale = (q.float().abs() * (s * w)[:, None].abs()).sum(0)
    err = (out.double() - exp.double()).abs()
    return float(err.max()), bool((err <= 1e-6 * scale.double()
                                   + 1e-30).all())


# the C of the reference's `bench_comm_agg` (8, 64) and of the acceptance
# run (32), at the paper CNN's N
DEQUANT_MAIN = [(8, 7900), (32, 7900), (64, 7900)]
DEQUANT_EDGE = [(1, 7900, ""), (4, 1, ""), (7, 7901, ""), (7, 7902, ""),
                (33, 7901, ""), (33, 7902, ""), (65, 7900, ""),
                (1024, 7900, ""), (12288, 7900, ""), (16, 1 << 20, ""),
                (32, 7900, "zero"), (32, 7900, "pm127"),
                (32, 7900, "zero_scale"), (32, 7900, "zero_weight")]
# the edge where bytes, not the launch, decide the time (~21 MB): timed,
# with its streaming rate
DEQUANT_STREAM = (16, 1 << 20)


def _dequant_case(C, N, gen, kind=""):
    import torch
    q = torch.randint(-127, 128, (C, N), generator=gen, dtype=torch.int8)
    s = torch.rand((C,), generator=gen) * 2e-2 + 1e-3
    w = torch.rand((C,), generator=gen) + 0.1
    if kind == "zero":
        q.zero_()
    elif kind == "pm127":
        q = torch.where(torch.rand((C, N), generator=gen) < 0.5, 127,
                        -127).to(torch.int8)
    elif kind == "zero_scale":
        s[0] = 0.0
    elif kind == "zero_weight":
        w[-1] = 0.0
    return q.cuda(), s.cuda(), (w / w.sum()).cuda()


def measure_comm_twin(C):
    """The port's twin of the reference's `measure_comm`
    (benchmarks/kernel_bench.py): C initial CNNs raveled, int8-quantized
    with per-client scales, aggregated through `ops.dequant_aggregate`
    and, dense, through `ops.fedavg_aggregate`, with the analytic
    compression ratios. It is not timed here: `_dequant_rows` times the
    kernel at the same shapes."""
    import torch
    from repro_torch import device as device_mod
    from repro_torch.core import codecs
    from repro_torch.core.engine import stack_forest
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import init_cnn
    from repro_torch.tree import tree_map

    stacked = stack_forest([tree_map(lambda t: t.cuda(),
                                     init_cnn(device_mod.generator(i)))
                            for i in range(C)])
    mat = ops.stacked_ravel(stacked)
    n = int(mat.shape[1])
    w = torch.full((C,), 1.0 / C, device="cuda")
    scale = mat.abs().amax(dim=1) / 127.0
    q = torch.clamp(torch.round(mat / scale[:, None]), -127, 127).to(
        torch.int8)
    out = ops.dequant_aggregate(q, scale, w)
    dense = ops.fedavg_aggregate(mat, w)
    err, ok = _dequant_err(out, (q.float() * scale[:, None]
                                 * w[:, None]).sum(0), q, scale, w)
    if not ok:
        raise SystemExit(f"measure_comm twin C={C}: dequant_agg off its "
                         f"plain value by {err}")
    fl = FLConfig(strategy="afl", num_clients=C, participation=1.0)
    return {"C": C, "n_params": n, "max_abs_err": err,
            "max_gap_to_dense_fedavg": float((out - dense).abs().max()),
            "topk_ratio": 4 * n / codecs.get_codec("topk")(fl)
            .bytes_on_wire(n),
            "qsgd_ratio": 4 * n / codecs.get_codec("qsgd")(fl)
            .bytes_on_wire(n)}


def real_payload_check():
    """`dequant_agg` on real payloads: the port's qsgd encoding of the 32
    trained uploads of event 0 of `comm-qsgd-accept-32c-vec` on the card,
    against `fedavg_agg` over the decoded matrix (what the round driver
    computes) within 1e-6 of sum_c |s_c w_c q[c, n]|."""
    import numpy as np
    import torch
    from repro_torch.core import codecs, scenarios
    from repro_torch.kernels import ops

    spec = scenarios.get("comm-qsgd-accept-32c-vec")
    sim = scenarios.resolve(spec, "cuda")
    rng = np.random.default_rng(spec.seed)
    strat = sim.strategy
    state = strat.init_state(sim)
    plan = strat.select_participants(sim, state, 0, rng)
    uploads, _, _ = sim.local_train(plan, strat.local_spec(sim, state, plan),
                                    rng)
    mat = ops.stacked_ravel(uploads)
    payload, _ = sim.codec.encode(
        mat, codecs.upload_keys(spec.seed, 0, plan.participants))
    pw = np.asarray(sim.weights, np.float64)[plan.participants]
    w = torch.as_tensor((pw / pw.sum()).astype(np.float32), device="cuda")
    q, s = payload["q"], payload["scale"]
    fused = ops.dequant_aggregate(q, s, w)
    decoded = ops.fedavg_aggregate(sim.codec.decode(payload), w)
    err, ok = _dequant_err(fused, decoded, q, s, w)
    row = {"C": int(q.shape[0]), "N": int(q.shape[1]),
           "max_abs_err_vs_fedavg_of_decoded": err,
           "max_level": float(s.max())}
    print("  real payload", json.dumps(row), flush=True)
    if not ok:
        raise SystemExit(f"dequant_agg on real payloads disagrees with "
                         f"fedavg_agg over the decoded matrix: {row}")
    return row


def _cast_gemv(q, s, w):
    import torch
    return (s * w) @ q.to(torch.float32)


def dequant_row(C, N, kind, timed, gen):
    """`dequant_agg` at (C, N) against its plain version (the `kind` edge
    values of `_dequant_case`); when `timed`, also timed beside the plain
    version and a cast plus a GEMV, with its bound, the share of it the
    kernel reaches, its streaming rate and a digest of its output's bits
    (at `DEQUANT_STREAM` from device memory: see `input_copies`). At
    (32, 7900) the kernel must repeat bitwise."""
    import hashlib

    import torch
    from repro_torch.kernels import comm_agg as ca

    q, s, w = _dequant_case(C, N, gen, kind)
    before = ca.launches
    out = ca.dequant_agg(q, s, w)
    torch.cuda.synchronize()
    if ca.launches != before + 1:
        raise SystemExit("dequant_agg: the wrapper did not launch")
    exp = ca.dequant_agg_torch(q, s, w)
    err, ok = _dequant_err(out, exp, q, s, w)
    row = {"C": C, "N": N, "kind": kind, "max_abs_err": err,
           "tol": "1e-6 x sum_c |s_c w_c q[c, n]|",
           "design": ("rows over warps, word loads" if N % 4 == 0
                      else "rows over warps, byte loads")}
    if not (out.dtype == torch.float32 and out.shape == (N,) and ok):
        raise SystemExit(f"dequant_agg disagrees with its plain "
                         f"version: {row}")
    if kind == "zero" and bool(out.any()):
        raise SystemExit("dequant_agg: all-zero uploads gave non-zero")
    if timed:
        # the main shapes stay in the 50 MB L2 between calls, as they do
        # on their path; the streaming edge cycles through copies of its
        # inputs that together exceed L2, so each call reads device memory
        copies = [(q, s, w)] + [
            tuple(t.clone() for t in (q, s, w))
            for _ in range(math.ceil(L2_BYTES * 2 / q.numel())
                           if (C, N) == DEQUANT_STREAM else 0)]
        nxt = itertools.cycle(copies).__next__
        fns = {"": lambda: ca.dequant_agg(*nxt()),
               "plain_": lambda: ca.dequant_agg_torch(*nxt()),
               # no single PyTorch call takes int8 input: a cast and
               # a GEMV, timed only
               "cast_gemv_": lambda: _cast_gemv(*nxt())}
        for key, fn in fns.items():
            row[f"{key}ms"] = _time_ms(fn)
            row[f"{key}graph_ms"] = _graph_ms(fn)
        row["input_copies"] = len(copies)
        row["bound_ms"], row["bound_by"] = _dequant_bound(C, N)
        row["bound_share"] = _share(row)
        # bytes each input read once, the output written once, over the
        # graph time: the kernel's streaming rate
        row["graph_gb_per_s"] = ((C * N + 4 * N + 8 * C)
                                 / (row["graph_ms"] * 1e-3) / 1e9)
        row["out_sha256"] = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()
    if (C, N, kind) == (32, 7900, ""):
        # no atomics: the partial sums are added in one fixed order
        row["bitwise_repeat"] = all(
            torch.equal(ca.dequant_agg(q, s, w), out) for _ in range(3))
        if not row["bitwise_repeat"]:
            raise SystemExit(f"dequant_agg is not bitwise repeatable: "
                             f"{row}")
    return row


def _dequant_rows():
    import torch
    from repro_torch.kernels import comm_agg as ca

    gen = torch.Generator().manual_seed(3)
    cases = ([(C, N, "", True) for C, N in DEQUANT_MAIN]
             + [(C, N, kind, (C, N) == DEQUANT_STREAM)
                for C, N, kind in DEQUANT_EDGE])
    rows = []
    for C, N, kind, timed in cases:
        row = dequant_row(C, N, kind, timed, gen)
        print("  dequant_agg", json.dumps(row), flush=True)
        rows.append(row)
    try:
        ca.dequant_agg(torch.zeros((4, 8), device="cuda"),
                       torch.ones(4, device="cuda"),
                       torch.ones(4, device="cuda"))
    except TypeError:
        pass
    else:
        raise SystemExit("dequant_agg took float32 values")
    return rows


def transport_kernel_phase():
    """8(a): the measure_comm twin and the real payload, with the launch
    counts set to 0 just before and read just after (the main path of
    B4), then B4 against its plain version at every shape."""
    import torch
    from repro_torch.kernels import comm_agg as ca

    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_launches()                    # B4's main path starts here
    twins = [measure_comm_twin(C) for C, _ in DEQUANT_MAIN]
    real = real_payload_check()
    torch.cuda.synchronize()
    launches = ca.launches
    for t in twins:
        print("  measure_comm twin", json.dumps(t), flush=True)
    if launches == 0:
        raise SystemExit("phase 8(a): dequant_agg was launched no time")
    print(f"  measure_comm twin + real payload: dequant_agg launched "
          f"{launches} times", flush=True)
    return {"launches": launches, "measure_comm": twins,
            "real_payload": real, "rows": _dequant_rows()}


# slice 4 on each aggregation seam (4 clients, 2 rounds / 2 tick batches)
TRANSPORT_PARITY = {
    "afl-topk": dict(strategy="afl", codec="topk", topk_frac=0.1),
    "hfl-topk": dict(strategy="hfl", codec="topk", topk_frac=0.1),
    "afl-qsgd": dict(strategy="afl", codec="qsgd"),
    "afl-qsgd-signflip-median": dict(strategy="afl", codec="qsgd",
                                     attack="sign_flip", attack_scale=4.0,
                                     defense="median"),
    "cfl-qsgd": dict(strategy="cfl", codec="qsgd"),
    "async-uniform": dict(strategy="async", speed_model="uniform",
                          updates_per_client=2, tick=1.0),
    "async-topk": dict(strategy="async", speed_model="uniform",
                       updates_per_client=2, tick=1.0, codec="topk",
                       topk_frac=0.25),
    "async-gauss-clip": dict(strategy="async", speed_model="uniform",
                             updates_per_client=2, tick=1.0, attack="gauss",
                             attack_scale=3.0, defense="norm_clip",
                             clip_tau=3.0),
}


# Each upload may flip one qsgd level or swap one top-k pair (one
# coordinate dropped, one shipped) between card and CPU: phase 8(b) lets at
# most this many coordinates per upload exceed the base tolerance.
FLIPS_PER_UPLOAD = 2


def _watch_codec(sim):
    """Record, per encode of `sim`'s codec, the size of one level (qsgd
    int8: the scale; top-k: the k-th largest |delta|) and the uploads
    encoded, and, at event 0, the encode's inputs and payload."""
    codec = sim.codec
    encode = codec.encode
    sim.levels, sim.first, sim.uploads = [], [], 0

    def watched(mat, keys, *, base=None, rows=None):
        sim.uploads += len(keys)
        payload, new_rows = encode(mat, keys, base=base, rows=rows)
        if "scale" in payload:
            sim.levels.append(float(payload["scale"].max()))
        else:
            sim.levels.append(float(payload["values"].abs().min(1)
                                    .values.max()))
        if keys and keys[0][1] == 0:
            sim.first.append((mat, keys, base, rows, payload, new_rows))
        return payload, new_rows

    codec.encode = watched


def _codec_weight(fl):
    """The largest weight one upload carries into the round model. A
    trimmed mean of C values keeping C - 2f moves by at most 1/(C - 2f)
    of what one value moves (sorting is 1-Lipschitz in l1); the median
    keeps 1 (odd C) or 2 (even C). Robust defenses run here on AFL's
    star, over all clients."""
    if fl.defense in ("median", "trimmed_mean"):
        c = fl.num_clients
        f = (c - 1) // 2 if fl.defense == "median" else \
            fl.resolved_defense_f()
        return 1.0 / (c - 2 * f)
    if fl.strategy == "cfl":
        return fl.merge_alpha
    if fl.strategy == "async":
        return fl.staleness_alpha
    if fl.strategy == "hfl":
        return fl.num_groups / fl.num_clients
    return 1.0 / fl.num_clients


def _encode_again_on_cpu(label, sim):
    """Event 0's payloads from the card, encoded again on the CPU from the
    card's own inputs: bitwise equal."""
    import torch

    def cpu(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        return x.cpu()

    for mat, keys, base, rows, payload, new_rows in sim.first:
        again, again_rows = sim.codec.__class__(sim.fl).encode(
            cpu(mat), keys, base=cpu(base), rows=cpu(rows))
        pairs = [(payload[k], again[k]) for k in payload]
        if new_rows is not None and again_rows is not None:
            pairs += [(new_rows[k], again_rows[k]) for k in new_rows]
        if not all(torch.equal(a.cpu(), b) for a, b in pairs):
            raise SystemExit(f"parity {label}: event 0's payload encoded "
                             f"on the CPU from the card's inputs differs")


def transport_parity_phase(device="cuda", reference="cpu"):
    """8(b): the port on `device` against the port on `reference` with a
    codec on the wire and under the async runtime, both engines."""
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.data.synthetic import mnist_like

    ds = mnist_like(seed=0, n_train=512, n_test=128)
    report = {}
    for name, kw in TRANSPORT_PARITY.items():
        for engine in ("loop", "vectorized"):
            label = f"{name}/{engine}"
            fl = FLConfig(**dict(PARITY_CFG, participation=1.0,
                                 engine=engine, **kw))

            def make(d):
                sim = FederatedSimulation(fl, ds, device=d)
                if sim.codec is not None:
                    _watch_codec(sim)
                return sim

            def level(sim):
                seen, sim.levels = sim.levels, []
                uploads, sim.uploads = sim.uploads, 0
                return (_codec_weight(sim.fl) * max(seen, default=0.0),
                        uploads)

            diffs, tol, sims, beyond = _parity(
                label, make, device, reference,
                level=level if fl.codec != "none" else None)
            if sims[0].codec is not None:
                _encode_again_on_cpu(label, sims[0])
                if sims[0]._comm_log != sims[1]._comm_log:
                    raise SystemExit(f"parity {label}: wire logs differ")
            report[label] = {"max_abs_diff_per_event": diffs, "tol": tol,
                             "coordinates_beyond_tol": beyond}
    return report


# The acceptance pair's |dF1| (the reference's bar: <= 0.02) is printed,
# not gated: the CPU rehearsal (tests/torch_reference_probe.py comm32)
# meets the bar from the reference's init but not from the port's own,
# whose dense run dips late (PERF.md section 7).
COMM_GATE_F1 = False


def transport_phase(device="cuda"):
    """8(c): the slice's study through the scenario runner."""
    from repro_torch.core import codecs, scenarios
    from repro_torch.kernels import comm_agg as ca
    from repro_torch.kernels import fedavg_agg as fa

    recorded = {d["scenario"]: d["communication"] for d in json.loads(
        (ROOT / "experiments" / "comm" / "acceptance.json").read_text())}
    names = scenarios.CODEC_SCENARIOS + scenarios.ASYNC_SCENARIOS
    _reset_launches()                    # the main path's count starts here
    t0 = time.perf_counter()
    results = {}
    for name in names:
        t1 = time.perf_counter()
        results[name] = r = scenarios.run(name, device=device)
        comm = scenarios.communication_block(r)
        print(f"  {name}: test_acc={r.test_accuracy:.4f} f1={r.f1:.4f} "
              f"build={r.build_time_s:.3f}s "
              f"launches={r.extra['kernel_launches']}"
              + ("" if comm is None else
                 f" compression={comm['compression_ratio']}")
              + f" ({time.perf_counter() - t1:.1f}s)", flush=True)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    launches = {"fedavg_agg": fa.launches, "dequant_agg": ca.launches}
    seconds = time.perf_counter() - t0
    out = {"seconds": seconds, "launches": launches, "runs": []}
    for name, r in results.items():
        spec = scenarios.get(name)
        values = ([getattr(r, k) for k in _METRICS] + list(r.round_train_acc)
                  + list(r.round_train_loss) + list(r.round_test_acc))
        if not all(math.isfinite(v) for v in values):
            raise SystemExit(f"{name}: non-finite metric")
        comm = scenarios.communication_block(r)
        if spec.codec == "none" and comm is not None:
            raise SystemExit(f"{name}: a dense run has a communication "
                             f"block")
        if spec.codec != "none":
            codec = codecs.get_codec(spec.codec)(spec.to_fl_config())
            ratio = 4 * 7900 / codec.bytes_on_wire(7900)
            if comm["compression_ratio"] != ratio:
                raise SystemExit(f"{name}: compression ratio "
                                 f"{comm['compression_ratio']} != {ratio}")
            if r.extra["kernel_launches"]["dequant_agg"]:
                raise SystemExit(f"{name}: a codec run launched "
                                 f"dequant_agg")
        if name in recorded and comm != recorded[name]:
            raise SystemExit(f"{name}: communication block {comm} differs "
                             f"from the reference's recorded "
                             f"{recorded[name]}")
        if (device == "cuda" and spec.strategy == "async"
                and r.extra["kernel_launches"]["fedavg_agg"] == 0):
            raise SystemExit(f"{name}: fedavg_agg never launched")
        row = dict(r.row(), scenario=name,
                   kernel_launches=r.extra["kernel_launches"],
                   warmup_time_s=r.warmup_time_s,
                   round_test_acc=r.round_test_acc, communication=comm)
        if spec.strategy == "async":
            row.update({k: r.extra[k] for k in
                        ("merges", "batches", "mean_staleness", "makespan",
                         "dropped_clients")})
        out["runs"].append(row)
    qsgd, dense = (results[n].f1 for n in scenarios.COMM_ACCEPTANCE_PAIR)
    out["acceptance_delta_f1"] = qsgd - dense
    print(f"  acceptance pair: macro-F1 qsgd {qsgd:.4f}, dense {dense:.4f}, "
          f"|dF1| {abs(qsgd - dense):.4f} (the reference's bar 0.02; its "
          f"recorded pair 0.9549 / 0.9439)", flush=True)
    if COMM_GATE_F1 and abs(qsgd - dense) > 0.02:
        raise SystemExit(f"acceptance pair |dF1| {abs(qsgd - dense)} > 0.02")
    if launches["dequant_agg"]:
        raise SystemExit("transport path: a codec run launched dequant_agg")
    print(f"  transport path: launches {launches} in {seconds:.1f}s",
          flush=True)
    return out


# -- phase 9 -----------------------------------------------------------------

H100_BF16_FLOPS = 989e12         # dense bf16 tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12         # dense TF32 tensor cores, H100 SXM data sheet
ZAMBA, YI = "zamba2-1.2b", "yi-9b"


def _bound(nbytes, flops, dtype):
    """Least time for the work: the bytes over the memory rate, the
    operations over the peak rate of their type. bfloat16 inputs: the bf16
    tensor cores, once. float32 inputs: the zoo's kernels run every
    product as three TF32 products (3xTF32), the least work that keeps
    float32's precision on the tensor cores, so three times the
    operations over the TF32 peak."""
    import torch
    if dtype == torch.bfloat16:
        t_ops = flops / H100_BF16_FLOPS
    else:
        t_ops = 3 * flops / H100_TF32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _attn_pairs(S, T, causal, window):
    """(query, key) pairs the masks keep: the work this call's data
    needs (the kernel skips whole masked tiles; the rest is masked)."""
    total = 0
    for s in range(S):
        hi = min(s, T - 1) if causal else T - 1
        lo = max(0, s - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


BF16_ULP = 2.0 ** -7         # a bfloat16 ulp, relative to the value


def _flash_bound(B, S, T, H, Hk, d, causal, window, dtype):
    import torch
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * S * H * d + 2 * B * T * Hk * d) * item
    flops = 4 * B * H * d * _attn_pairs(S, T, causal, window)
    return _bound(nbytes, flops, dtype)


def _ssm_bound(B, S, H, dh, N, Q, dtype):
    """x read and y written, Bm and Cm read once (not per head), a and dt
    in float32; 2 operations per product. Per chunk, the lower triangle
    of C B^T once (Bm and Cm are shared by the heads); per chunk and head
    the lower triangle of W x, C state^T and the state update."""
    import torch
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * S * H * dh + 2 * B * S * N) * item + 2 * B * S * H * 4
    nc = S // Q
    flops = (B * nc * Q * (Q + 1) * N
             + B * H * nc * (Q * (Q + 1) * dh + 4 * Q * dh * N))
    return _bound(nbytes, flops, dtype)


def _big_ms(fn):
    """Per call and in a CUDA graph, with few samples: the zoo's calls
    take milliseconds."""
    return _time_ms(fn, samples=5, inner=3), _graph_ms(fn, inner=3,
                                                       samples=3)


def _rel_err(out, want):
    """(max |out - want|, max |want|)."""
    out, want = out.float(), want.float()
    return (float((out - want).abs().max()), float(want.abs().max()))


# (label, B, S, T, H, Hk, d, causal, window): zamba2-1.2b's shared block
# at its prefill (B = 2, S = 4096, 32 heads of 64) and yi-9b's layers at
# S = 2048 (32 query heads on 4 key/value heads of 128) are the main
# path's shapes; then a window, no mask, T != S, the shortest tiling and
# the widest head
FLASH_MAIN = [("zamba2-1.2b", 2, 4096, 4096, 32, 32, 64, True, 0),
              ("yi-9b", 1, 2048, 2048, 32, 4, 128, True, 0)]
# phase 12's new B5 shape, timed as the main ones: phi-3-vision's 32 heads
# of 96 over 576 patches + 1472 tokens (qwen3-moe's layers have yi-9b's
# shape)
FLASH_ZOO = [("phi-3-vision-4.2b", 1, 2048, 2048, 32, 32, 96, True, 0)]
FLASH_EDGE = [("window-256", 1, 2048, 2048, 8, 8, 64, True, 256),
              ("non-causal", 1, 1024, 1024, 8, 8, 64, False, 0),
              ("T!=S", 1, 1024, 2048, 8, 2, 128, True, 0),
              ("S=128", 2, 128, 128, 4, 4, 64, True, 0),
              ("d=256", 1, 512, 512, 4, 2, 256, True, 0)]
# the bfloat16 kernel only: head dims off the float32 kernel's set (zero
# columns up to the next 64: d = 160 and 192 take the 192-column tiles), a
# half query tile (S % 128 == 64) with 8 query heads per key/value head
FLASH_EDGE_BF16 = [("d=80", 1, 1024, 1024, 8, 4, 80, True, 0),
                   ("d=48", 1, 1024, 1024, 8, 8, 48, True, 128),
                   ("d=192", 1, 1024, 1024, 8, 4, 192, True, 256),
                   ("d=160", 1, 1024, 1024, 8, 8, 160, True, 128),
                   ("S=192 G=8", 2, 192, 192, 16, 2, 128, True, 0)]
# the first port's graph times in ms, before the redesign (PERF.md section
# 6), printed on the progress lines beside this run's for reading only: not
# a gate, and not in the kernels line
FIRST_PORT_FLASH_GRAPH_MS = {
    (ZAMBA, "bfloat16"): 5.837, (ZAMBA, "float32"): 5.753,
    (YI, "bfloat16"): 1.918, (YI, "float32"): 1.978}


def _flash_rows():
    import torch

    gen = torch.Generator().manual_seed(9)
    cases = ([(c, dt, True) for c in FLASH_MAIN + FLASH_ZOO
              for dt in (torch.bfloat16, torch.float32)]
             + [(c, dt, False) for c in FLASH_EDGE
                for dt in (torch.float32, torch.bfloat16)]
             + [(c, torch.bfloat16, False) for c in FLASH_EDGE_BF16])
    rows = []
    for case, dtype, main in cases:
        row = flash_row(case, dtype, main, gen)
        key = (row["case"], row["dtype"])
        first = ({"first_port_graph_ms": FIRST_PORT_FLASH_GRAPH_MS[key]}
                 if key in FIRST_PORT_FLASH_GRAPH_MS else {})
        print("  flash_attention", json.dumps({**row, **first}),
              flush=True)
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def flash_row(case, dtype, main, gen):
    """`flash_attention` at one (label, B, S, T, H, Hk, d, causal, window)
    against its plain version; on a main shape also timed beside the
    plain version and SDPA, with its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fl

    label, B, S, T, H, Hk, d, causal, window = case
    q = torch.randn((B, S, H, d), generator=gen).to("cuda", dtype)
    k = torch.randn((B, T, Hk, d), generator=gen).to("cuda", dtype)
    v = torch.randn((B, T, Hk, d), generator=gen).to("cuda", dtype)
    before = fl.launches
    out = fl.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if fl.launches != before + 1:
        raise SystemExit("flash_attention: the wrapper did not launch")
    want = fl.flash_attention_torch(q, k, v, causal=causal, window=window)
    err, _ = _rel_err(out, want)
    # float32: the same sums in another order, within 1e-5; bfloat16:
    # both round float32 results that agree that closely, so each
    # element is at most one bfloat16 ulp (2^-7 of |want|) apart
    tol = 1e-5 if dtype == torch.float32 else "2^-7 |want| + 1e-5"
    ok = err <= 1e-5 if dtype == torch.float32 else bool(
        ((out.float() - want.float()).abs()
         <= BF16_ULP * want.float().abs() + 1e-5).all())
    row = {"case": label, "B": B, "S": S, "T": T, "H": H, "Hk": Hk,
           "d": d, "causal": causal, "window": window,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol}
    if not (out.dtype == dtype and out.shape == q.shape and ok):
        raise SystemExit(f"flash_attention disagrees with its plain "
                         f"version: {row}")
    if main:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        fns = {"": lambda: fl.flash_attention(q, k, v, causal=causal),
               "plain_": lambda: fl.flash_attention_torch(
                   q, k, v, causal=causal),
               # the yardstick, timed only: the port never calls it
               "library_": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=H != Hk)}
        for key, fn in fns.items():
            row[f"{key}ms"], row[f"{key}graph_ms"] = _big_ms(fn)
        row["bound_ms"], row["bound_by"] = _flash_bound(
            B, S, T, H, Hk, d, causal, window, dtype)
        flops = 4 * B * H * d * _attn_pairs(S, T, causal, window)
        row["tflops"] = flops / (row["graph_ms"] * 1e-3) / 1e12
        row["bound_share"] = _share(row)
        row["design"] = ("wgmma" if dtype == torch.bfloat16
                         else "3xtf32 mma")
    return row


# (label, B, S, H, dh, N): zamba2-1.2b's prefill (64 heads of 64, state
# 64), then one chunk, a sequence shorter than the chunk (N = 16,
# dh = 32, the reduced model's widths), and a mid size
SSM_MAIN = [("zamba2-1.2b", 2, 4096, 64, 64, 64)]
SSM_EDGE = [("one chunk", 1, 128, 4, 32, 16), ("S<chunk", 1, 64, 4, 32, 16),
            ("mid", 2, 1024, 8, 64, 64)]


def _ssm_inputs(B, S, H, dh, N, gen, dtype):
    """Inputs shaped as mamba2_forward makes them: dt = softplus(.) near
    zamba2's dt_bias range, a = A dt with A = -(1..16), x, B, C after a
    SiLU."""
    import torch
    import torch.nn.functional as F
    dt = F.softplus(torch.randn((B, S, H), generator=gen) - 4.0)
    a = -torch.linspace(1.0, 16.0, H) * dt
    xh = F.silu(torch.randn((B, S, H, dh), generator=gen))
    Bm = F.silu(torch.randn((B, S, N), generator=gen))
    Cm = F.silu(torch.randn((B, S, N), generator=gen))
    return (xh.to("cuda", dtype), a.cuda(), dt.cuda(), Bm.to("cuda", dtype),
            Cm.to("cuda", dtype))


def _ssm_rows():
    import torch

    gen = torch.Generator().manual_seed(10)
    cases = ([(c, dt, True) for c in SSM_MAIN
              for dt in (torch.bfloat16, torch.float32)]
             + [(c, dt, False) for c in SSM_EDGE
                for dt in (torch.float32, torch.bfloat16)])
    rows = []
    for case, dtype, main in cases:
        row = ssm_row(case, dtype, main, gen)
        print("  ssm_scan", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def ssm_row(case, dtype, main, gen):
    """`ssm_scan` at one (label, B, S, H, dh, N) against its plain
    version; on a main shape also timed beside the plain version, with its
    bound."""
    import torch
    from repro_torch.kernels import ssm_scan as ss

    label, B, S, H, dh, N = case
    xh, a, dt, Bm, Cm = _ssm_inputs(B, S, H, dh, N, gen, dtype)
    before = ss.launches
    y = ss.ssm_scan(xh, a, dt, Bm, Cm)
    torch.cuda.synchronize()
    if ss.launches != before + 1:
        raise SystemExit("ssm_scan: the wrapper did not launch")
    want = ss.ssm_scan_torch(xh, a, dt, Bm, Cm)
    err, scale = _rel_err(y, want)
    # relative to max |y|: products of the size of y summed in another
    # order and exp of a cumsum taken in another order (float32);
    # bfloat16 rounds the output
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
    row = {"case": label, "B": B, "S": S, "H": H, "dh": dh, "N": N,
           "chunk": min(128, S), "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "max_abs_y": scale, "tol": tol}
    if not (y.dtype == dtype and y.shape == xh.shape and err <= tol
            and bool(torch.isfinite(y).all())):
        raise SystemExit(f"ssm_scan disagrees with its plain version: "
                         f"{row}")
    if main:
        fns = {"": lambda: ss.ssm_scan(xh, a, dt, Bm, Cm),
               "plain_": lambda: ss.ssm_scan_torch(xh, a, dt, Bm, Cm)}
        for key, fn in fns.items():
            row[f"{key}ms"], row[f"{key}graph_ms"] = _big_ms(fn)
        row["bound_ms"], row["bound_by"] = _ssm_bound(
            B, S, H, dh, N, min(128, S), dtype)
        row["bound_share"] = _share(row)
    return row


def _ssm_state_check():
    """B6's first two passes on the card (each chunk's own state, then the
    states passed from chunk to chunk) against the plain rendering of the
    passes, at the "mid" edge shape in both types: the states entering
    every chunk within 1e-4 (float32) / 2e-2 (bfloat16: x o u is rounded
    to bf16 once, and the states are stored in bf16) of their largest
    magnitude."""
    import torch
    from repro_torch.kernels import ssm_scan as ss

    label, B, S, H, dh, N = next(c for c in SSM_EDGE if c[0] == "mid")
    gen = torch.Generator().manual_seed(11)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = _ssm_inputs(B, S, H, dh, N, gen, dtype)
        h_in = ss.ssm_chunk_states(*args)
        _, want = ss.ssm_scan_passes_torch(*args)
        err, scale = _rel_err(h_in, want)
        tol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
        row = {"case": label, "states": list(h_in.shape),
               "max_abs_err": err, "max_abs_h": scale, "tol": tol}
        if not (h_in.shape == want.shape and err <= tol
                and bool(torch.isfinite(h_in).all())):
            raise SystemExit(f"ssm_scan's chunk states disagree with the "
                             f"plain passes: {row}")
        out[str(dtype).replace("torch.", "")] = row
    print("  ssm_scan chunk states " + json.dumps(out), flush=True)
    return out


def _occupancy():
    """Resident blocks per SM and shared memory per block at the main
    path's shapes, from the CUDA occupancy API: B5's tiles at d = 64 and
    128 in both types, B6's three passes at zamba2's widths in both
    types."""
    import ctypes
    from repro_torch.kernels import build

    queries = [("flash_attention d=64", "flash_attention", (64, 1)),
               ("flash_attention d=128", "flash_attention", (128, 1)),
               ("flash_attention f32 d=64", "flash_attention", (64, 0)),
               ("flash_attention f32 d=128", "flash_attention", (128, 0))]
    for dtype, code in (("bf16", 1), ("f32", 0)):
        for kernel, pass_ in (("ssd_chunk_state", 1), ("ssd_state_pass", 2),
                              ("ssd_chunk_scan", 3)):
            queries.append((f"ssm_scan {kernel} {dtype} dh=64 N=64",
                            "ssm_scan", (pass_, code, 64, 64, 128)))
    out = {}
    for name, lib, args in queries:
        query = getattr(build.load(lib), f"{lib}_occupancy")
        query.argtypes = [ctypes.c_int] * len(args) + [
            ctypes.POINTER(ctypes.c_int)] * 2
        query.restype = ctypes.c_int
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        err = query(*args, ctypes.byref(blocks), ctypes.byref(smem))
        if err != 0:
            raise SystemExit(f"{lib}_occupancy{args}: cudaError {err}")
        out[name] = {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}
    print("  occupancy " + json.dumps(out), flush=True)
    return out


def zoo_kernel_phase():
    """9(a): B5 and B6 against their plain versions at the main path's
    shapes and at edge shapes, timed beside the plain version and, for
    B5, scaled_dot_product_attention."""
    import torch
    from repro_torch.device import deterministic_f32
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ssm_scan as ss

    deterministic_f32()
    out = {"flash_attention": _flash_rows(), "ssm_scan": _ssm_rows(),
           "ssm_chunk_states": _ssm_state_check(),
           "occupancy": _occupancy()}
    # shapes off the kernels' envelopes raise before any launch: S off the
    # 64-row tiling, a float32 head dim off the SIMT kernel's set; S off
    # the chunk, a head dim and a state width the scan does not take
    xh = torch.zeros((1, 200, 2, 64), device="cuda")
    q48 = torch.zeros((1, 128, 2, 48), device="cuda")
    x48 = torch.zeros((1, 256, 2, 48), device="cuda")
    n200 = torch.zeros((1, 256, 200), device="cuda")
    a = torch.zeros((1, 256, 2), device="cuda")
    before = (fl.launches, ss.launches)
    for bad in (lambda: fl.flash_attention(xh[:, :96].contiguous(),
                                           xh[:, :96].contiguous(),
                                           xh[:, :96].contiguous()),
                lambda: fl.flash_attention(q48, q48, q48),
                lambda: ss.ssm_scan(xh, xh[..., 0], xh[..., 0],
                                    xh[:, :, 0, :16].contiguous(),
                                    xh[:, :, 0, :16].contiguous()),
                lambda: ss.ssm_scan(x48, a, a, n200[..., :16].contiguous(),
                                    n200[..., :16].contiguous()),
                lambda: ss.ssm_scan(x48[..., :32].contiguous(), a, a, n200,
                                    n200)):
        try:
            bad()
        except ValueError:
            continue
        raise SystemExit("a zoo kernel took a shape it does not tile")
    if (fl.launches, ss.launches) != before:
        raise SystemExit("a zoo kernel launched on a shape it refused")
    return out


def kernel_prefill(model, params, tokens):
    """The served prefill (`make_prefill_step`) with every mamba layer
    through `ssm.mamba2_forward(..., use_kernel=True)`, the reference's
    kernel path. `transformer.forward` looks the function up through the
    module, so it is rebound for this call and restored after."""
    import functools
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models import ssm
    orig = ssm.mamba2_forward
    ssm.mamba2_forward = functools.partial(orig, use_kernel=True)
    try:
        return make_prefill_step(model)(params, {"tokens": tokens})
    finally:
        ssm.mamba2_forward = orig


def _counts():
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ssm_scan as ss
    return {"flash_attention": fl.launches, "ssm_scan": ss.launches}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _expect(label, delta, want):
    if delta != want:
        raise SystemExit(f"{label}: kernel launches {delta}, expected "
                         f"{want}")


def _decode(model, params, tokens, n, device):
    """Teacher-forced decode_step over tokens[:, :n] -> (B, n, V)."""
    import torch
    state = model.init_decode_state(tokens.shape[0], n, device=device)
    out = []
    for t in range(n):
        lg, state = model.decode_step(params, state, tokens[:, t:t + 1])
        out.append(lg)
    return torch.cat(out, dim=1)


def zoo_parity_phase(device="cuda", reference="cpu"):
    """9(b): zamba2 reduced to 4 layers (the shared block runs before
    layer 2) in float32 at S = 256, on the card against the CPU: the flash
    prefill, the kernel prefill and 8 decode steps, each within 1e-4, and
    a second card run bitwise equal to the first."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.model import build_model, synthetic_train_batch
    from repro_torch.tree import tree_map

    deterministic_f32()
    cfg = get_config(ZAMBA).reduced(dtype="float32", num_layers=4,
                                    block_pattern=("mamba",) * 4,
                                    attn_impl="flash")
    model = build_model(cfg)
    ref_params = model.init(generator(0), device=reference)
    params = tree_map(lambda a: a.to(device), ref_params)
    tokens = synthetic_train_batch(generator(1), cfg, 2, 256,
                                   device=reference)["tokens"]

    def run(dev, p):
        toks = tokens.to(dev)
        before = _counts()
        out = {"flash_prefill": make_prefill_step(model)(p, {"tokens": toks}),
               "kernel_prefill": kernel_prefill(model, p, toks),
               "decode": _decode(model, p, toks, 8, dev)}
        if dev != "cpu":
            torch.cuda.synchronize()
        return out, _delta(before)

    ref, ref_delta = run(reference, ref_params)
    first, delta = run(device, params)
    second, _ = run(device, params)
    if device == "cuda":
        # the shared block runs before layer 2 in both prefills
        _expect("9(b) card run", delta, {"flash_attention": 2,
                                         "ssm_scan": 4})
    _expect("9(b) CPU run", ref_delta, {"flash_attention": 0, "ssm_scan": 0})
    out = {}
    for key in ref:
        err = float((first[key].cpu() - ref[key]).abs().max())
        bitwise = bool(torch.equal(first[key], second[key]))
        out[key] = {"max_abs_err": err, "bitwise_repeat": bitwise}
        print(f"  {key}: card vs CPU {err:.3e}, repeat bitwise {bitwise}",
              flush=True)
        if not (err <= 1e-4 and bitwise):
            raise SystemExit(f"9(b) {key}: card vs CPU {err} > 1e-4 or the "
                             f"repeat differs")
    return out


def _timed(fn):
    """(fn(), host milliseconds around it, synchronized on the card)."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


# the port's zoo kernels (B5's two instantiations, B6's three passes),
# listed by _profile even when they fall outside its top rows
PORT_KERNELS = ("flash_tc_kernel", "flash_tf32_kernel", "ssd_chunk_state",
                "ssd_state_pass", "ssd_chunk_scan")


def _profile(fn, top=8):
    """Device time by kernel over one call of fn, from torch.profiler:
    {"wall_ms", "device_busy_ms", "idle_share", "kernels": [[name, ms,
    launches, share of busy], ...]} (the `top` longest, then any of the
    port's kernels below them), or None when the profiler records no
    device time. The profiler's own host cost lengthens the wall time, so
    the idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: host op events are not read, and recording
    # them costs minutes on a prefill of ~150 k launches (xlstm's sLSTM)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append([e.key[:80], us / 1e3, e.count])
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    for r in rows:
        r.append(r[1] / busy)
    kept = rows[:top] + [r for r in rows[top:]
                         if any(k in r[0] for k in PORT_KERNELS)]
    port = {}                    # ms and launches of each of the port's
    for name, marks in (("flash_attention", PORT_KERNELS[:2]),   # kernels,
                        ("ssm_scan", PORT_KERNELS[2:])):        # passes summed
        mine = [r for r in rows if any(k in r[0] for k in marks)]
        port[name] = [sum(r[1] for r in mine), sum(r[2] for r in mine),
                      sum(r[1] for r in mine) / busy]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall), "kernels": kept,
            "port_kernels": port}


F32_PREFILL_TOL = 1e-3    # relative to max |logits|: float32 sums in another
                          # order through 38 layers (the reading is printed)


def zamba2_phase(device="cuda", seed=0, B=2, S=4096):
    """9(c): zamba2-1.2b at full width and depth, random weights from a
    seed; the one change from the published config is dtype="float32"
    for the gates (bfloat16 readings printed)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.launch.serve import (make_decode_dispatch,
                                          make_prefill_step)
    from repro_torch.models import decode
    from repro_torch.models.model import build_model, synthetic_train_batch

    deterministic_f32()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ZAMBA).with_updates(dtype="float32", attn_impl="flash")
    plain = cfg.with_updates(attn_impl="einsum")
    model = build_model(cfg)
    params, init_ms = _timed(lambda: model.init(generator(seed), device))
    n_params = model.param_count(params)
    tokens = synthetic_train_batch(generator(seed + 1), cfg, B, S,
                                   device=device)["tokens"]
    batch = {"tokens": tokens}
    out = {"config": "zamba2-1.2b, dtype float32 (gates) and bfloat16 "
                     "(published), attn_impl flash, nothing cut",
           "params": n_params, "init_ms": init_ms, "B": B, "S": S}
    print(f"  {n_params} parameters, init {init_ms:.0f} ms", flush=True)

    cfg16 = cfg.with_updates(dtype="bfloat16")
    prefills = {          # name -> (the call, its launches: flash, scan)
        "plain_prefill": (lambda: make_prefill_step(build_model(plain))(
            params, batch), (0, 0)),
        "flash_prefill": (lambda: make_prefill_step(model)(params, batch),
                          (6, 0)),
        "kernel_prefill": (lambda: kernel_prefill(model, params, tokens),
                           (6, 38)),
        "plain_prefill_bf16": (lambda: make_prefill_step(build_model(
            cfg16.with_updates(attn_impl="einsum")))(params, batch), (0, 0)),
        "flash_prefill_bf16": (lambda: make_prefill_step(build_model(cfg16))(
            params, batch), (6, 0)),
        "kernel_prefill_bf16": (lambda: kernel_prefill(build_model(cfg16),
                                                       params, tokens),
                                (6, 38))}

    def prefill(name):
        fn, (n_flash, n_scan) = prefills[name]
        before = _counts()
        logits, ms = _timed(fn)
        _expect(name, _delta(before), {"flash_attention": n_flash,
                                       "ssm_scan": n_scan})
        if not (bool(torch.isfinite(logits).all())
                and logits.shape == (B, S, cfg.vocab_size)):
            raise SystemExit(f"9(c) {name}: non-finite or misshapen logits")
        out[f"{name}_first_ms"] = ms
        return logits

    def compare(label, got, ref):
        err, scale = _rel_err(got, ref)
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        out[label] = {"max_abs_err": err, "max_abs": scale,
                      "argmax_agree": agree}
        print(f"  {label}: max|d| {err:.3e} of max|logits| {scale:.3f}, "
              f"argmax agree {agree:.6f}", flush=True)
        return err, scale

    _reset_launches()                    # the main path's count starts here
    want = prefill("plain_prefill")
    for key in ("flash", "kernel"):
        err, scale = compare(f"f32 {key} prefill vs plain",
                             prefill(f"{key}_prefill"), want)
        if not err <= F32_PREFILL_TOL * scale:
            raise SystemExit(f"9(c) f32 {key} prefill: {err} > "
                             f"{F32_PREFILL_TOL} x {scale}")
    head = want[:, :64].clone()
    want16 = prefill("plain_prefill_bf16")   # the published dtype: printed
    for key in ("flash", "kernel"):
        got = prefill(f"{key}_prefill_bf16")
        compare(f"bf16 {key} prefill vs plain bf16", got, want16)
        compare(f"bf16 {key} prefill vs plain f32", got, want)
        del got
    del want, want16
    if on_card:
        torch.cuda.empty_cache()

    # serving, in float32
    dec, ms = _timed(lambda: _decode(model, params, tokens, 64, device))
    out["decode_first_ms_per_step"] = ms / 64
    err = float((dec - head).abs().max())
    out["decode_vs_prefill_max_abs_err"] = err
    print(f"  teacher-forced decode_step x 64 vs the prefill: {err:.3e} "
          f"(bar 5e-2), {ms / 64:.2f} ms/step at B = {B}", flush=True)
    if not err <= 5e-2:
        raise SystemExit(f"9(c) decode vs prefill {err} > 5e-2")
    gen = generator(seed + 2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    ref_logits = make_prefill_step(build_model(plain))(
        params, {"tokens": prompts.to(device)})[:, -1]
    top2 = ref_logits.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu()
    nxt = ref_logits.argmax(-1).cpu().numpy()
    dispatch = make_decode_dispatch(cfg, prompts.numpy(), nxt)
    correct, ms = _timed(lambda: dispatch(params, [0, 1, 2, 3]))
    out["dispatch"] = {"correct": correct.tolist(), "ms": ms,
                       "top2_margin": margin.tolist()}
    print(f"  make_decode_dispatch, 4 requests of 32 tokens: correct "
          f"{correct.tolist()} (top-2 margins {margin.tolist()}), "
          f"{ms:.0f} ms", flush=True)
    if not all(c or m < 5e-2 for c, m in zip(correct, margin.tolist())):
        raise SystemExit("9(c) dispatch missed a prediction the prefill "
                         "makes by a margin above 5e-2")
    prompt = prompts[:2].to(device)
    gen1, ms = _timed(lambda: decode.greedy_generate(params, cfg, prompt, 16))
    gen2 = decode.greedy_generate(params, cfg, prompt, 16)
    out["greedy"] = {"tokens": gen1[:, 32:].tolist(), "ms": ms,
                     "bitwise_repeat": bool(torch.equal(gen1, gen2))}
    print(f"  greedy_generate 16 tokens after 32: {ms:.0f} ms, repeat "
          f"bitwise {out['greedy']['bitwise_repeat']}", flush=True)
    if not out["greedy"]["bitwise_repeat"]:
        raise SystemExit("9(c) greedy generation differs on a repeat")
    out["launches"] = _counts()          # the main path's count ends here
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated() if on_card
                                else None)
    print(f"  peak memory {(out['peak_memory_bytes'] or 0) / 2**30:.2f} "
          f"GiB; launches {out['launches']}", flush=True)
    # steady times: three more runs of each prefill, host clock around the
    # synchronized call; the median is reported
    for name, (fn, _) in prefills.items():
        runs = [_timed(fn)[1] for _ in range(3)]
        out[f"{name}_ms_runs"] = runs
        out[f"{name}_ms"] = statistics.median(runs)
        out[f"{name}_tokens_per_s"] = B * S / (out[f"{name}_ms"] / 1e3)
        print(f"  {name}: {out[f'{name}_ms']:.1f} ms (runs "
              f"{', '.join(f'{r:.1f}' for r in runs)}; first "
              f"{out[f'{name}_first_ms']:.1f}), "
              f"{out[f'{name}_tokens_per_s']:.0f} tokens/s", flush=True)
    if on_card:                          # where the time goes
        for name, fn in (("kernel_prefill_bf16",
                          prefills["kernel_prefill_bf16"][0]),
                         ("flash_prefill", prefills["flash_prefill"][0]),
                         ("decode x16", lambda: _decode(model, params,
                                                        tokens, 16, device))):
            prof = _profile(fn)
            out[f"profile {name}"] = prof
            if prof is None:
                print(f"  profile {name}: no device time recorded (not "
                      f"measured)", flush=True)
                continue
            print(f"  profile {name}: wall {prof['wall_ms']:.1f} ms, device "
                  f"busy {prof['device_busy_ms']:.1f} ms, idle share <= "
                  f"{prof['idle_share']:.3f}", flush=True)
            for kname, ms, n, share in prof["kernels"]:
                print(f"    {ms:9.2f} ms {n:6d}x {share:6.1%}  {kname}",
                      flush=True)
            for kname, (ms, n, share) in prof["port_kernels"].items():
                print(f"    {ms:9.2f} ms {n:6d}x {share:6.1%}  {kname} "
                      f"(all its kernels)", flush=True)
    steps = [_timed(lambda: _decode(model, params, tokens, 16, device))[1]
             / 16 for _ in range(3)]
    out["decode_ms_per_step_runs"] = steps
    out["decode_ms_per_step"] = statistics.median(steps)
    print(f"  decode_step at B = {B}: {out['decode_ms_per_step']:.2f} "
          f"ms/step (3 runs of 16 steps: "
          f"{', '.join(f'{r:.2f}' for r in steps)})", flush=True)
    if on_card:
        out["card"] = _card_line()
        print(f"  on {out['card']}", flush=True)
    del params
    if on_card:
        torch.cuda.empty_cache()
    return out


def yi_phase(device="cuda", seed=0, B=1, S=2048, layers=4):
    """9(d): yi-9b at full width, 4 of its 48 layers (the one cut), random
    weights; one flash prefill against einsum in float32."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.model import build_model, synthetic_train_batch

    deterministic_f32()
    cfg = get_config(YI).with_updates(num_layers=layers, dtype="float32",
                                      attn_impl="flash")
    model = build_model(cfg)
    params = model.init(generator(seed), device)
    batch = {"tokens": synthetic_train_batch(generator(seed + 1), cfg, B, S,
                                             device=device)["tokens"]}
    want, plain_ms = _timed(lambda: make_prefill_step(build_model(
        cfg.with_updates(attn_impl="einsum")))(params, batch))
    _reset_launches()                    # the main path's count starts here
    got, ms = _timed(lambda: make_prefill_step(model)(params, batch))
    _expect("yi-9b flash prefill", _counts(), {"flash_attention": layers,
                                               "ssm_scan": 0})
    err, scale = _rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    out = {"config": f"yi-9b at full width, {layers} of 48 layers",
           "reduced": {"num_layers": [48, layers]},
           "params": model.param_count(params), "B": B, "S": S,
           "launches": _counts(), "max_abs_err": err, "max_abs": scale,
           "argmax_agree": agree, "flash_prefill_ms": ms,
           "plain_prefill_ms": plain_ms}
    print(f"  yi-9b ({layers} of 48 layers cut: num_layers 48 -> {layers}), "
          f"{out['params']} parameters: f32 flash prefill vs einsum max|d| "
          f"{err:.3e} of {scale:.3f}, argmax agree {agree:.6f}; "
          f"{ms:.1f} ms (einsum {plain_ms:.1f} ms)", flush=True)
    if not (err <= F32_PREFILL_TOL * scale and bool(torch.isfinite(got).all())):
        raise SystemExit(f"9(d) yi-9b flash prefill {err} > "
                         f"{F32_PREFILL_TOL} x {scale}")
    del params, want, got
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# -- phase 12 ----------------------------------------------------------------

MOE, MLA, XLSTM = "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "xlstm-125m"
SEAMLESS, VISION = "seamless-m4t-large-v2", "phi-3-vision-4.2b"
DECODE_TOL = 5e-2          # the reference's decode-vs-prefill bar
DECODE_STEPS = 64

# arch -> (depth cuts {field: (published, run)}, B, token positions, flash
# prefill gated against einsum, decode gated against the prefill). The
# widths are the published ones; the cuts keep float32 weights within the
# card (qwen3-moe whole is ~30.5 B parameters, 122 GB in float32).
ZOO_REST = {
    MOE: ({"num_layers": (48, 4)}, 1, 2048, True, True),
    MLA: ({"num_layers": (27, 4)}, 1, 2048, False, True),
    XLSTM: ({}, 2, 2048, False, True),
    SEAMLESS: ({}, 1, 1024, False, False),
    VISION: ({"num_layers": (32, 8)}, 1, 2048 - 576, True, False),
}


def _reduced_rest(arch):
    """12(b)'s reduced config: float32, xlstm with an sLSTM, the MoE
    configs at their default capacity factor (the prefill drops)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch).reduced(dtype="float32", attn_impl="flash")
    if arch == XLSTM:
        cfg = cfg.with_updates(block_pattern=("mlstm", "slstm"))
    return cfg


def zoo_rest_parity_phase(device="cuda", reference="cpu"):
    """12(b): the five configs of slice 11 reduced, on the card against the
    CPU from one init: the flash prefill over 128 positions (phi-3-vision:
    8 patches + 120 tokens; seamless: 16 encoder frames) and 8 decode
    steps, each within 1e-4, and a second card run bitwise equal to the
    first."""
    import torch
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.model import build_model, synthetic_train_batch
    from repro_torch.tree import tree_map

    deterministic_f32()
    out = {}
    for arch in ZOO_REST:
        cfg = _reduced_rest(arch)
        model = build_model(cfg)
        ref_params = model.init(generator(0), device=reference)
        params = tree_map(lambda a: a.to(device), ref_params)
        batch = synthetic_train_batch(generator(1), cfg, 2,
                                      128 - cfg.num_patches,
                                      device=reference)
        batch.pop("labels")

        def run(dev, p):
            b = {k: v.to(dev) for k, v in batch.items()}
            before = _counts()
            res = {"prefill": make_prefill_step(model)(p, b),
                   "decode": _decode(model, p, b["tokens"], 8, dev)}
            if dev != "cpu":
                torch.cuda.synchronize()
            return res, _delta(before)

        ref, ref_delta = run(reference, ref_params)
        first, delta = run(device, params)
        second, _ = run(device, params)
        n_flash = 0 if arch in (MLA, XLSTM) else cfg.num_layers
        if device == "cuda":
            _expect(f"12(b) {arch} card run", delta,
                    {"flash_attention": n_flash, "ssm_scan": 0})
        _expect(f"12(b) {arch} CPU run", ref_delta,
                {"flash_attention": 0, "ssm_scan": 0})
        row = {}
        for key in ref:
            err = float((first[key].cpu() - ref[key]).abs().max())
            bitwise = bool(torch.equal(first[key], second[key]))
            row[key] = {"max_abs_err": err, "bitwise_repeat": bitwise}
            if not (err <= 1e-4 and bitwise
                    and bool(torch.isfinite(first[key]).all())):
                raise SystemExit(f"12(b) {arch} {key}: card vs CPU {err} > "
                                 f"1e-4, the repeat differs or non-finite")
        print(f"  {arch}: card vs CPU prefill {row['prefill']['max_abs_err']:.3e}"
              f", decode {row['decode']['max_abs_err']:.3e}; repeats bitwise",
              flush=True)
        out[arch] = row
    return out


def zoo_rest_phase(arch, device="cuda", seed=0):
    """12(a), one config: at its published widths (depth cut as ZOO_REST
    lists), random weights from a seed, float32 for the gates and
    bfloat16 (published) timed; the plain (einsum) prefill, the flash
    prefill where B5 runs (gated against einsum), 64 teacher-forced decode
    steps gated against a 64-token prefill (MoE drop-free at
    capacity_factor = num_experts) or timed, the peak memory and the
    device busy / idle share of one bf16 prefill."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.model import build_model, synthetic_train_batch

    deterministic_f32()
    cuts, B, S_tok, flash, gate_decode = ZOO_REST[arch]
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    impl = "flash" if flash else "einsum"
    cfg = get_config(arch).with_updates(
        dtype="float32", attn_impl=impl,
        **{k: run for k, (_, run) in cuts.items()})
    n_flash = cfg.num_layers if flash else 0
    start, t0 = _counts(), time.perf_counter()
    model = build_model(cfg)
    params, init_ms = _timed(lambda: model.init(generator(seed), device))
    batch = synthetic_train_batch(generator(seed + 1), cfg, B, S_tok,
                                  device=device)
    batch.pop("labels")
    S = S_tok + cfg.num_patches
    out = {"config": f"{arch} at its published widths, dtype float32 "
                     f"(gates) and bfloat16 (published), attn_impl {impl}",
           "reduced": {k: list(v) for k, v in cuts.items()},
           "params": model.param_count(params), "init_ms": init_ms,
           "B": B, "S": S}
    print(f"  {arch}: {out['params']} parameters (cuts {out['reduced']}), "
          f"init {init_ms:.0f} ms on the host, B = {B}, S = {S}", flush=True)
    cfg16 = cfg.with_updates(dtype="bfloat16")
    prefills = {             # name -> (the call, its flash launches)
        "plain_prefill": (lambda: make_prefill_step(build_model(
            cfg.with_updates(attn_impl="einsum")))(params, batch), 0),
        "prefill_bf16": (lambda: make_prefill_step(build_model(cfg16))(
            params, batch), n_flash)}
    if flash:
        prefills["flash_prefill"] = (
            lambda: make_prefill_step(model)(params, batch), n_flash)

    def prefill(name):
        fn, want_flash = prefills[name]
        before = _counts()
        logits, ms = _timed(fn)
        _expect(f"12(a) {arch} {name}", _delta(before),
                {"flash_attention": want_flash, "ssm_scan": 0})
        if not (bool(torch.isfinite(logits).all())
                and logits.shape == (B, S, cfg.vocab_size)):
            raise SystemExit(f"12(a) {arch} {name}: non-finite or "
                             f"misshapen logits")
        out[f"{name}_first_ms"] = ms
        return logits

    want = prefill("plain_prefill")
    if flash:
        err, scale = _rel_err(prefill("flash_prefill"), want)
        out["f32 flash prefill vs plain"] = {"max_abs_err": err,
                                             "max_abs": scale}
        print(f"  f32 flash prefill vs plain: max|d| {err:.3e} of "
              f"max|logits| {scale:.3f}", flush=True)
        if not err <= F32_PREFILL_TOL * scale:
            raise SystemExit(f"12(a) {arch} f32 flash prefill: {err} > "
                             f"{F32_PREFILL_TOL} x {scale}")
    got16 = prefill("prefill_bf16")
    err, scale = _rel_err(got16, want)
    agree = float((got16.argmax(-1) == want.argmax(-1)).float().mean())
    out["bf16 prefill vs plain f32"] = {"max_abs_err": err, "max_abs": scale,
                                        "argmax_agree": agree}
    print(f"  bf16 prefill vs plain f32: max|d| {err:.3e} of {scale:.3f}, "
          f"argmax agree {agree:.4f} (printed)", flush=True)
    del want, got16
    if on_card:
        torch.cuda.empty_cache()

    # decode, in float32; the MoE configs drop-free, where decode and the
    # parallel pass agree
    dcfg = cfg.with_updates(attn_impl="einsum")
    if cfg.moe:
        dcfg = dcfg.with_updates(capacity_factor=float(cfg.num_experts))
    dmodel = build_model(dcfg)
    toks = batch["tokens"][:, :DECODE_STEPS]
    dec, ms = _timed(lambda: _decode(dmodel, params, toks, DECODE_STEPS,
                                     device))
    out["decode_first_ms_per_step"] = ms / DECODE_STEPS
    if not bool(torch.isfinite(dec).all()):
        raise SystemExit(f"12(a) {arch}: non-finite decode logits")
    if gate_decode:
        head = make_prefill_step(dmodel)(params, {"tokens": toks})
        err = float((dec - head).abs().max())
        out["decode_vs_prefill_max_abs_err"] = err
        print(f"  teacher-forced decode_step x {DECODE_STEPS} vs the "
              f"{DECODE_STEPS}-token prefill: {err:.3e} (bar {DECODE_TOL})",
              flush=True)
        if not err <= DECODE_TOL:
            raise SystemExit(f"12(a) {arch} decode vs prefill {err} > "
                             f"{DECODE_TOL}")
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                if on_card else None)
    # steady times: the host clock around the synchronized call, median
    # of 3 for the published dtype, one more run of each other prefill
    for name, (fn, _) in prefills.items():
        runs = [_timed(fn)[1] for _ in range(3 if name == "prefill_bf16"
                                             else 1)]
        out[f"{name}_ms_runs"] = runs
        out[f"{name}_ms"] = statistics.median(runs)
        out[f"{name}_tokens_per_s"] = B * S / (out[f"{name}_ms"] / 1e3)
        print(f"  {name}: {out[f'{name}_ms']:.1f} ms (runs "
              f"{', '.join(f'{r:.1f}' for r in runs)}; first "
              f"{out[f'{name}_first_ms']:.1f}), "
              f"{out[f'{name}_tokens_per_s']:.0f} tokens/s", flush=True)
    steps = _timed(lambda: _decode(dmodel, params, toks, 16, device))[1] / 16
    out["decode_ms_per_step"] = steps
    print(f"  decode_step at B = {B}: {steps:.2f} ms/step (16 steps; first "
          f"{DECODE_STEPS}: {out['decode_first_ms_per_step']:.2f}); peak "
          f"memory {(out['peak_memory_bytes'] or 0) / 2**30:.2f} GiB",
          flush=True)
    if on_card:                          # where the time goes
        prof = _profile(prefills["prefill_bf16"][0])
        out["profile prefill_bf16"] = prof
        if prof is None:
            print("  profile prefill_bf16: no device time recorded (not "
                  "measured)", flush=True)
        else:
            print(f"  profile prefill_bf16: wall {prof['wall_ms']:.1f} ms, "
                  f"device busy {prof['device_busy_ms']:.1f} ms, idle share "
                  f"<= {prof['idle_share']:.3f}", flush=True)
            for kname, kms, n, share in prof["kernels"]:
                print(f"    {kms:9.2f} ms {n:6d}x {share:6.1%}  {kname}",
                      flush=True)
        out["card"] = _card_line()
    out["launches"] = _delta(start)      # every prefill and decode above
    out["seconds"] = time.perf_counter() - t0
    print(f"  {arch}: launches {out['launches']}, {out['seconds']:.1f}s in "
          f"all", flush=True)
    del params
    if on_card:
        torch.cuda.empty_cache()
    return out


def zoo_rest_main_phase(device="cuda"):
    """12(a): the five configs in turn, each model freed before the next;
    the kernels' counts start at 0 here and are read at the end."""
    _reset_launches()                    # the main path's count starts here
    t0 = time.perf_counter()
    runs = {arch: zoo_rest_phase(arch, device) for arch in ZOO_REST}
    launches = _counts()                 # the main path's count ends here
    # each prefill's launches were gated above (B5 once a layer in the
    # flash prefills of qwen3-moe and phi-3-vision, never elsewhere)
    if launches["flash_attention"] == 0 or launches["ssm_scan"] != 0:
        raise SystemExit(f"12(a): launches {launches}")
    seconds = time.perf_counter() - t0
    print(f"  phase 12(a) launches {launches}, {seconds:.1f}s (host init "
          f"{sum(r['init_ms'] for r in runs.values()) / 1e3:.1f}s of it)",
          flush=True)
    return {"runs": runs, "launches": launches, "seconds": seconds}


# -- phase 13 ----------------------------------------------------------------

TRAIN_REL = 1e-5          # loss and grad-norm, card vs CPU, relative
TRAIN_PARAM_ATOL = 1e-6   # params after one SGD step (lr 1e-2, clipped to
                          # norm 1), card vs CPU: lr x a gradient off by
                          # ~1e-6 of its norm moves a parameter ~1e-8
TRAIN_CUT = {"num_layers": (38, 7)}   # the shared block runs once, layer 6


def _kernel_counts():
    from repro_torch.kernels import comm_agg as ca
    from repro_torch.kernels import fedavg_agg as fa
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import ssm_scan as ss
    return {"fedavg_agg": fa.launches, "trimmed_mean_agg": ra.launches,
            "gossip_mix_agg": gm.launches, "dequant_agg": ca.launches,
            "flash_attention": fl.launches, "ssm_scan": ss.launches}


def _train_cut_cfg(**kw):
    from repro_torch.configs.registry import get_config
    layers = TRAIN_CUT["num_layers"][1]
    return get_config(ZAMBA).with_updates(
        dtype="float32", num_layers=layers,
        block_pattern=("mamba",) * layers, **kw)


def _step_once(cfg, params, batch, opt, device):
    """One make_train_step from `params` (moved to `device`) -> (params,
    metrics as floats); the step's inputs are left as they were."""
    import torch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map
    p = tree_map(lambda a: a.to(device), params)
    b = {k: v.to(device) for k, v in batch.items()}
    p, _, m = make_train_step(build_model(cfg), opt)(p, opt.init(p), b)
    if device != "cpu":
        torch.cuda.synchronize()
    return p, {k: float(v) for k, v in m.items()}


def _leaves_err(a, b):
    from repro_torch.tree import tree_leaves
    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _leaves_equal(a, b):
    import torch
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def train_parity_phase(device="cuda", reference="cpu", B=2, S=256):
    """13(a): zamba2-1.2b at full width, depth cut 38 -> 7 (the shared
    block runs once, before layer 6, at its published cadence), float32,
    B = 2, S = 256: one SGD step (lr 1e-2) and one AdamW step on the card
    against the CPU from one init; the SGD step repeated bitwise on the
    card; then on the card grad_accum = 2 against 1 over the same global
    batch, and remat on against off."""
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.models.model import build_model, synthetic_train_batch
    from repro_torch.optim import optimizers

    deterministic_f32()
    cfg = _train_cut_cfg()
    print(f"  zamba2-1.2b cut {TRAIN_CUT}: {cfg.num_layers} Mamba2 layers, "
          f"shared block before layer {cfg.shared_attn_every}; float32, "
          f"B = {B}, S = {S}", flush=True)
    params = build_model(cfg).init(generator(0), reference)
    batch = synthetic_train_batch(generator(1), cfg, B, S, device=reference)
    out = {"cut": TRAIN_CUT, "B": B, "S": S}
    sgd = optimizers.sgd(1e-2)
    adamw = optimizers.adamw(3e-4, weight_decay=0.01)
    before = _kernel_counts()

    def gate(label, got, want, params_gated=True):
        (gp, gm), (wp, wm) = got, want
        rel = {k: abs(gm[k] - wm[k]) / max(abs(wm[k]), 1e-30)
               for k in ("loss", "grad_norm")}
        perr = _leaves_err(gp, wp)
        out[label] = {"metrics": gm, "rel": rel, "param_max_abs_err": perr}
        print(f"  {label}: loss {gm['loss']:.6f} grad-norm "
              f"{gm['grad_norm']:.6f}; rel {rel['loss']:.2e} / "
              f"{rel['grad_norm']:.2e}; params max|d| {perr:.3e}"
              f"{'' if params_gated else ' (printed)'}", flush=True)
        if not (max(rel.values()) <= TRAIN_REL
                and (perr <= TRAIN_PARAM_ATOL or not params_gated)):
            raise SystemExit(f"13(a) {label}: rel {rel} > {TRAIN_REL} or "
                             f"params {perr} > {TRAIN_PARAM_ATOL}")

    ref_sgd, ms = _timed(lambda: _step_once(cfg, params, batch, sgd,
                                            reference))
    out["cpu_sgd_ms"] = ms
    card_sgd, ms = _timed(lambda: _step_once(cfg, params, batch, sgd,
                                             device))
    out["card_sgd_ms"] = ms
    gate("sgd card vs CPU", card_sgd, ref_sgd)
    again = _step_once(cfg, params, batch, sgd, device)
    bitwise = _leaves_equal(again[0], card_sgd[0]) and again[1] == card_sgd[1]
    out["sgd_bitwise_repeat"] = bitwise
    print(f"  sgd repeat on the card bitwise {bitwise}", flush=True)
    if not bitwise:
        raise SystemExit("13(a): the card's SGD step differs on a repeat")
    del again, ref_sgd
    # AdamW's first step moves a parameter by ~lr times the sign of its
    # gradient, which flips where a gradient sums to ~0 in another order:
    # its parameters are printed, its loss and grad-norm gated
    gate("adamw card vs CPU", _step_once(cfg, params, batch, adamw, device),
         _step_once(cfg, params, batch, adamw, reference),
         params_gated=False)
    for label, kw in (("grad_accum 2 vs 1 (card)", {"grad_accum": 2}),
                      ("remat off vs on (card)", {"remat": False})):
        gate(label, _step_once(_train_cut_cfg(**kw), params, batch, sgd,
                               device), card_sgd)
    delta = {k: v - before[k] for k, v in _kernel_counts().items()}
    out["launches"] = delta
    if any(delta.values()):
        raise SystemExit(f"13(a): kernels launched {delta}")
    return out


def zamba2_train_phase(device="cuda", seed=0, B=4, S=2048, accum=2,
                       timed=4, repeats=6):
    """13(b): zamba2-1.2b whole (38 Mamba2 layers and the shared block) at
    its published dtypes (bfloat16 activations, float32 parameters,
    remat), MarkovLM batches over its 32,000 tokens, global batch
    B x S with grad_accum, AdamW (3e-4, weight decay 0.01, clip 1.0): a
    warm-up step and `timed` steps on fresh batches, then `repeats` steps
    on one repeated batch, the first of them profiled."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import MarkovLM
    from repro_torch.device import generator
    from repro_torch.launch import roofline
    from repro_torch.launch.train import device_batch, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import optimizers
    from repro_torch.tree import tree_leaves

    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ZAMBA).with_updates(grad_accum=accum)
    model = build_model(cfg)
    params, init_ms = _timed(lambda: model.init(generator(seed), device))
    n_params = model.param_count(params)
    active = roofline.active_param_count(cfg, n_params)
    lm = MarkovLM(cfg.vocab_size, seed=seed)
    batches, data_ms = _timed(lambda: [
        device_batch(b, device) for b in lm.batches(B, S, timed + 1,
                                                    seed=seed)])
    print(f"  zamba2-1.2b whole: {n_params} parameters ({cfg.dtype} "
          f"activations, {cfg.param_dtype} parameters, remat "
          f"{cfg.remat}); init {init_ms:.0f} ms, {timed + 1} MarkovLM "
          f"batches of {B} x {S} in {data_ms:.0f} ms; grad_accum {accum}",
          flush=True)
    opt = optimizers.adamw(3e-4, weight_decay=0.01)
    opt_state = opt.init(params)
    step = make_train_step(model, opt, clip_norm=1.0)
    losses, norms = [], []

    def run(b):
        nonlocal params, opt_state
        params, opt_state, m = step(params, opt_state, b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        norms.append(gnorm)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise SystemExit(f"13(b) step {len(losses)}: loss {loss}, "
                             f"grad-norm {gnorm}")

    before = _kernel_counts()
    _, warm_ms = _timed(lambda: run(batches[0]))
    times = [_timed(lambda: run(b))[1] for b in batches[1:timed + 1]]
    step_ms = statistics.median(times)
    tokens = B * S
    flops = roofline.model_flops_per_step(cfg, tokens, active)
    out = {"config": "zamba2-1.2b (configs/zamba2_1_2b.py), nothing cut",
           "params": n_params, "active_params": active, "B": B, "S": S,
           "grad_accum": accum, "init_ms": init_ms, "warmup_ms": warm_ms,
           "step_ms_runs": times, "step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu": roofline.mfu(step_ms / 1e3, flops)}
    print(f"  train step: {step_ms:.1f} ms median of {timed} (range "
          f"{min(times):.1f}-{max(times):.1f}; warm-up {warm_ms:.0f}), "
          f"{out['tokens_per_s']:.0f} tokens/s, MFU {out['mfu']:.4f} "
          f"(6 N D = {flops:.3e} FLOPs over {roofline.PEAK_FLOPS:.3g} "
          f"FLOP/s)", flush=True)
    rep = []
    if on_card:              # the first step on the repeated batch, profiled
        prof = _profile(lambda: run(batches[0]))
        rep.append(losses[-1])
        out["profile"] = prof
        if prof is None:
            print("  profile: no device time recorded (not measured)",
                  flush=True)
        else:
            print(f"  profile of one step: wall {prof['wall_ms']:.1f} ms, "
                  f"device busy {prof['device_busy_ms']:.1f} ms, idle "
                  f"share <= {prof['idle_share']:.3f}", flush=True)
            for kname, ms, n, share in prof["kernels"]:
                print(f"    {ms:9.2f} ms {n:6d}x {share:6.1%}  {kname}",
                      flush=True)
    while len(rep) < repeats:
        run(batches[0])
        rep.append(losses[-1])
    out["repeated_batch_losses"] = rep
    out["losses"], out["grad_norms"] = losses, norms
    print(f"  {repeats} steps on one batch: losses "
          f"{', '.join(f'{x:.4f}' for x in rep)}", flush=True)
    if not rep[-1] < rep[0]:
        raise SystemExit(f"13(b): the repeated batch's loss did not fall "
                         f"({rep})")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)):
        raise SystemExit("13(b): non-finite parameters after training")
    delta = {k: v - before[k] for k, v in _kernel_counts().items()}
    out["launches"] = delta
    if any(delta.values()):
        raise SystemExit(f"13(b): kernels launched {delta}")
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                if on_card else None)
    print(f"  peak memory {(out['peak_memory_bytes'] or 0) / 2**30:.2f} "
          f"GiB; launches {delta}", flush=True)
    if on_card:
        out["card"] = _card_line()
        print(f"  on {out['card']}", flush=True)
    del params, opt_state, batches
    if on_card:
        torch.cuda.empty_cache()
    return out


FL_TRAIN_CASES = {
    "hfl": dict(strategy="hfl"),
    "afl": dict(strategy="afl"),
    "afl-gossip": dict(strategy="afl", afl_mode="gossip"),
    "cfl": dict(strategy="cfl", merge_alpha=0.3),
}


def _fl_setup(cfg, case, C, K, B, S, device, seed=0, **kw):
    import torch
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.device import generator
    from repro_torch.models.model import build_model, synthetic_train_batch
    fl = FLConfig(**dict(FL_TRAIN_CASES[case], num_clients=C, num_groups=2,
                         local_steps=K, lr=0.05, **kw))
    tr = FederatedTrainer(build_model(cfg), fl)
    state = tr.init_state(generator(seed), device=device)
    gen = generator(seed + 1)
    rows = [synthetic_train_batch(gen, cfg, B, S, device=device)
            for _ in range(C * K)]
    batch = {k: torch.stack([r[k] for r in rows]).reshape(
        (C, K) + tuple(rows[0][k].shape)) for k in rows[0]}
    weights = torch.arange(1, C + 1, dtype=torch.float32, device=device)
    part = torch.ones(C, dtype=torch.bool, device=device)
    return tr, state, batch, weights, part


def fl_train_parity_phase(device="cuda", reference="cpu"):
    """13(c), first half: the reference test's config (phi3-mini-3.8b
    reduced, in float32; 4 clients in 2 groups, K = 2, lr 0.05) for one
    round of each strategy from one init, on the card against the CPU
    (1e-4), with a bitwise repeat on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.device import deterministic_f32
    from repro_torch.tree import tree_map

    deterministic_f32()
    cfg = get_config("phi3-mini-3.8b").reduced(dtype="float32")
    out = {}
    for case in FL_TRAIN_CASES:
        tr, state, batch, w, part = _fl_setup(cfg, case, 4, 2, 2, 32,
                                              reference)
        ref, rm = tr.fl_train_step(state, batch, w, part)

        def card():
            move = lambda t: tree_map(lambda a: a.to(device), t)  # noqa
            return tr.fl_train_step(move(state), move(batch), w.to(device),
                                    part.to(device))
        first, fm = card()
        second, _ = card()
        err = max(_leaves_err(first["client_params"], ref["client_params"]),
                  abs(float(fm["loss"]) - float(rm["loss"])))
        bitwise = _leaves_equal(first["client_params"],
                                second["client_params"])
        out[case] = {"max_abs_err": err, "bitwise_repeat": bitwise,
                     "loss": float(fm["loss"])}
        print(f"  {case}: card vs CPU {err:.3e}, repeat bitwise {bitwise}",
              flush=True)
        if not (err <= 1e-4 and bitwise):
            raise SystemExit(f"13(c) {case}: card vs CPU {err} > 1e-4 or "
                             f"the repeat differs")
    return out


def fl_train_phase(device="cuda", C=4, K=2, B=2, S=256, rounds=2):
    """13(c), second half: xlstm-125m whole (12 layers, sLSTM at 3, 7 and
    11; published dtypes), 4 clients in 2 groups, K = 2 local steps of
    2 x 256 tokens, 2 rounds each of HFL, AFL (all clients in the first
    round, client 0 alone in the second) and CFL (alpha 0.3). Gates:
    every client's params bitwise equal after each HFL and AFL round, CFL's
    clients apart, round == 2, finite losses."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.tree import tree_leaves

    on_card = device == "cuda"
    cfg = get_config(XLSTM)
    out = {}
    before = _kernel_counts()
    for case in ("hfl", "afl", "cfl"):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        tr, state, batch, w, part = _fl_setup(cfg, case, C, K, B, S, device)
        secs, losses, spreads = [], [], []
        for r in range(rounds):
            if case == "afl" and r == 1:
                part = torch.zeros_like(part)       # client 0 alone
                part[0] = True
            (state, m), ms = _timed(lambda: tr.fl_train_step(state, batch, w,
                                                             part))
            secs.append(ms / 1e3)
            losses.append(float(m["loss"]))
            spreads.append(max(float((x - x[0:1]).abs().max())
                               for x in tree_leaves(state["client_params"])))
        row = {"seconds_per_round": secs, "losses": losses,
               "client_spread": spreads, "round": int(state["round"]),
               "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                     if on_card else None)}
        out[case] = row
        print(f"  {case}: {', '.join(f'{x:.2f}' for x in secs)} s/round, "
              f"losses {', '.join(f'{x:.4f}' for x in losses)}, clients "
              f"apart by {', '.join(f'{x:.3e}' for x in spreads)}, peak "
              f"{(row['peak_memory_bytes'] or 0) / 2**30:.2f} GiB",
              flush=True)
        apart = [x > 0.0 for x in spreads]
        consensus_ok = all(apart) if case == "cfl" else not any(apart)
        if not (all(math.isfinite(x) for x in losses) and row["round"] == 2
                and consensus_ok):
            raise SystemExit(f"13(c) {case}: {row}")
        del tr, state, batch
    delta = {k: v - before[k] for k, v in _kernel_counts().items()}
    out["launches"] = delta
    if any(delta.values()):
        raise SystemExit(f"13(c): kernels launched {delta}")
    return out


def train_phase(device="cuda"):
    """Phase 13: the zoo's training and the federated trainer (slice
    12); every kernel's count is 0 at its start and read at its end."""
    _reset_launches()                    # the main path's count starts here
    t0 = time.perf_counter()
    print("  -- (a) card against CPU: zamba2-1.2b at full width, 7 layers",
          flush=True)
    parity = train_parity_phase(device, "cpu")
    print("  -- (b) zamba2-1.2b whole: 38 layers and the shared block",
          flush=True)
    zamba = zamba2_train_phase(device)
    print("  -- (c) the federated trainer", flush=True)
    fl_parity = fl_train_parity_phase(device, "cpu")
    fl = fl_train_phase(device)
    launches = _kernel_counts()          # the main path's count ends here
    if any(launches.values()):
        raise SystemExit(f"phase 13: kernels launched {launches}")
    seconds = time.perf_counter() - t0
    print(f"  phase 13 launches {launches}, {seconds:.1f}s", flush=True)
    return {"parity": parity, "zamba2": zamba, "fl_parity": fl_parity,
            "fl": fl, "launches": launches, "seconds": seconds}


# -- phase 10 ----------------------------------------------------------------

# the result document's keys and the keys of its always-present blocks
# (schema v2.5, the reference's `run_scenario`)
DOC_KEYS = ("schema_version", "scenario", "spec", "strategy", "metrics",
            "timing", "async", "attack", "communication", "telemetry",
            "serving", "faults")
DOC_METRICS = ("test_accuracy", "train_accuracy", "precision", "recall",
               "f1", "balanced_accuracy")
DOC_TIMING = ("build_time_s", "warmup_time_s", "steady_time_s",
              "classification_time_s", "rounds_per_s")
DOC_TELEMETRY = ("enabled", "phases", "run", "fused_phase_proxy",
                 "counters", "series", "dispatch", "peak_rss_mb")


def _check_document(name, doc):
    """Fail unless `doc` has schema v2.5's keys and blocks, survives a
    JSON round trip and the port's `load_result` unchanged, and holds
    finite metrics. An optional block (async, attack, communication,
    serving, faults) is null exactly when the spec leaves its axis off,
    and an object otherwise (phase 10's 7 registrations are clean, dense,
    sync and fault-free, so theirs are all null)."""
    from repro_torch.core import scenarios
    from repro_torch.core.strategies import STRATEGY_REGISTRY_VERSION

    spec = scenarios.get(name)
    want = {"schema_version": scenarios.RESULT_SCHEMA_VERSION,
            "scenario": name, "spec": spec.asdict(),
            "strategy": {"plugin": spec.strategy,
                         "registry_version": STRATEGY_REGISTRY_VERSION}}
    wrong = [k for k, v in want.items() if doc.get(k) != v]
    present = {"async": spec.strategy == "async",
               "attack": spec.attack != "none" or spec.defense != "none",
               "communication": spec.codec != "none",
               "serving": spec.serve,
               "faults": spec.fault_profile != "none"}
    wrong += [k for k, on in present.items()
              if isinstance(doc.get(k), dict) != on
              or (not on and doc.get(k) is not None)]
    if (tuple(doc) != DOC_KEYS or wrong
            or tuple(doc["metrics"]) != DOC_METRICS
            or tuple(doc["timing"]) != DOC_TIMING
            or tuple(doc["telemetry"]) != DOC_TELEMETRY):
        raise SystemExit(f"{name}: the result document differs from "
                         f"schema 2.5 (keys {list(doc)}, blocks {wrong})")
    if scenarios.load_result(json.loads(json.dumps(doc))) != doc:
        raise SystemExit(f"{name}: the result document does not survive "
                         f"json and load_result")
    if not all(math.isfinite(v) for v in doc["metrics"].values()):
        raise SystemExit(f"{name}: non-finite metric {doc['metrics']}")


def result_doc_phase(device="cuda"):
    """10: the 7 loop and vectorized registrations of the reference's
    baseline grid through `run_scenario` (the schema-v2.5 result
    document), each checked by `_check_document`; on the card each must
    launch `fedavg_agg` (HFL, AFL and vectorized CFL aggregate through
    it)."""
    from repro_torch.core import scenarios
    from repro_torch.kernels import fedavg_agg as fa

    _reset_launches()                    # the main path's count starts here
    t0 = time.perf_counter()
    out = {"runs": []}
    for name in scenarios.BASELINE_SCENARIOS:
        before = fa.launches
        t1 = time.perf_counter()
        doc = scenarios.run_scenario(name, device=device)
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        launches = fa.launches - before
        _check_document(name, doc)
        m, t = doc["metrics"], doc["timing"]
        print(f"  {name}: test_acc={m['test_accuracy']:.4f} "
              f"f1={m['f1']:.4f} precision={m['precision']:.4f} "
              f"recall={m['recall']:.4f} "
              f"balanced_acc={m['balanced_accuracy']:.4f} "
              f"build={t['build_time_s']:.3f}s "
              f"rounds_per_s={t['rounds_per_s']:.3f} "
              f"fedavg_agg launches={launches} "
              f"({time.perf_counter() - t1:.1f}s)", flush=True)
        if device == "cuda" and launches == 0:
            raise SystemExit(f"{name}: fedavg_agg was launched no time")
        out["runs"].append({"scenario": name, "metrics": m, "timing": t,
                            "fedavg_agg_launches": launches})
    out["fedavg_agg_launches"] = fa.launches
    out["seconds"] = time.perf_counter() - t0
    print(f"  result documents: fedavg_agg launched {fa.launches} times in "
          f"{out['seconds']:.1f}s", flush=True)
    return out


# -- phase 11 ----------------------------------------------------------------

# the reference's own fused-parity configurations (tests/test_fused.py):
# 8 clients x 32 images, the paper CNN at full width (N = 7900 float32)
FUSED_DS = dict(seed=0, n_train=256, n_test=128)
FUSED_CFG = dict(num_clients=8, num_groups=2, rounds=2, local_epochs=1,
                 local_batch_size=16, lr=0.05, seed=0, participation=1.0)
FUSED_CASES = {
    "hfl": dict(strategy="hfl", rounds=3),
    "afl-p0.5": dict(strategy="afl", participation=0.5),
    "cfl": dict(strategy="cfl"),
    "fedprox": dict(strategy="fedprox", prox_mu=0.1),
    "fedavgm": dict(strategy="fedavgm", server_lr=0.7, server_momentum=0.9),
    "fedadam": dict(strategy="fedadam", server_lr=0.1),
    "afl-gossip": dict(strategy="afl", afl_mode="gossip"),
    "afl-signflip-median": dict(strategy="afl", attack="sign_flip",
                                attack_scale=4.0, defense="median",
                                rounds=3),
}
# then two registrations, each at its own configuration and data
FUSED_REGISTRATION_CASES = ("churn-afl-gossip-mtd", "comm-qsgd-hfl-fused")
# the reference's fused tolerances (tests/test_fused.py)
FUSED_TOL = {"round_train_acc": 1e-5, "round_train_loss": 1e-4,
             "round_test_acc": 1e-5, "train_accuracy": 1e-5,
             "test_accuracy": 1e-5, "f1": 1e-5}
_RESULT_FIELDS = ("round_train_acc", "round_train_loss", "round_test_acc",
                  "train_accuracy", "test_accuracy", "precision", "recall",
                  "f1", "balanced_accuracy")


def _served_leaves(sim):
    from repro_torch.tree import tree_leaves
    return tree_leaves(sim.strategy.round_model(sim.final_state))


def _same_leaves(a, b):
    return all(x.equal(y) for x, y in zip(_served_leaves(a),
                                          _served_leaves(b)))


def _fused_case(label, make, device, reference, codec=False):
    """Four runs of one configuration: the vectorized engine, the fused
    engine (one CUDA graph of a round, replayed) and the fused eager loop
    on `device`, and the fused engine on `reference`. Fails unless the
    graph run is within the reference's fused tolerances of the
    vectorized run with the same confusion matrix, equals the eager run
    bit for bit (metrics, curves, served model), and its served model is
    within phase 4's tolerance of the `reference` run
    (HFL 1e-3, else 1e-4; printed, not gated, for FedAdam — ROADMAP C.2 —
    and with a codec on the wire, where a quantization level may flip
    between devices). Whether the graph run's served model is the
    vectorized run's bit for bit is printed.

    On the card a profile of each fused run's build window
    (`obs.collectors.device_window`) counts the round kernels executed on
    the device, and fails unless the graph run's replays launched the
    same kernels as the eager rounds, no wrapper is called in the graph
    run's window (so the replays launched them), and the eager window's
    profile agrees with its wrappers' counts."""
    import numpy as np
    from repro_torch.obs import collectors

    vsim = make("vectorized", device)
    rv = vsim.run()
    boxes = {"graph": {}, "eager": {}}
    gsim = make("fused", device)
    esim = make("fused", device)
    if device == "cuda":
        gsim.build_hook = collectors.device_window(boxes["graph"])
        esim.build_hook = collectors.device_window(boxes["eager"])
    rg = gsim.run()
    re_ = esim.run_fused(graph=False)
    csim = make("fused", reference)
    csim.run()
    gaps = {k: float(np.max(np.abs(np.asarray(getattr(rg, k), np.float64)
                                   - np.asarray(getattr(rv, k),
                                                np.float64))))
            for k in FUSED_TOL}
    bad = [k for k, v in gaps.items() if not v <= FUSED_TOL[k]]
    if bad or not (rg.confusion == rv.confusion).all():
        raise SystemExit(f"fused {label}: graph run vs vectorized beyond "
                         f"the fused tolerances {bad} {gaps} (confusion "
                         f"equal: {(rg.confusion == rv.confusion).all()})")
    same = (all(np.array_equal(np.asarray(getattr(rg, k)),
                               np.asarray(getattr(re_, k)), equal_nan=True)
                for k in _RESULT_FIELDS)
            and (rg.confusion == re_.confusion).all()
            and _same_leaves(gsim, esim))
    if not same:
        raise SystemExit(f"fused {label}: the graph run differs from the "
                         f"eager fused run")
    lg = boxes["graph"].get("kernels")
    if device == "cuda":
        le = boxes["eager"]["kernels"]
        calls = {m: boxes[m]["wrapper_calls"] for m in boxes}
        if (lg != le or le != calls["eager"] or any(calls["graph"].values())
                or not sum(lg.values())):
            raise SystemExit(
                f"fused {label}: kernels executed in the build window: graph "
                f"replays {lg}, eager {le}; wrapper calls there {calls}")
    tol = 1e-3 if gsim.fl.strategy == "hfl" else 1e-4
    gated = gsim.fl.strategy != "fedadam" and not codec
    card_cpu = 0.0
    for x, y in zip(_served_leaves(gsim), _served_leaves(csim)):
        x, y = x.cpu().double().numpy(), y.cpu().double().numpy()
        if not (np.isfinite(x).all() and np.isfinite(y).all()):
            raise SystemExit(f"fused {label}: non-finite served model")
        if gated and not np.allclose(x, y, atol=tol, rtol=tol):
            raise SystemExit(f"fused {label}: {device} vs {reference} "
                             f"beyond {tol}")
        card_cpu = max(card_cpu, float(np.abs(x - y).max()))
    vec_bits = _same_leaves(gsim, vsim)
    print(f"  {label}: graph vs vectorized {gaps}, confusion equal, "
          f"served model bitwise {vec_bits}; graph == eager bitwise; "
          f"replayed launches {lg} (profiled, == eager); served model "
          f"|{device} - {reference}| "
          f"{card_cpu:.3g} "
          f"({f'tol {tol}' if gated else 'printed, not gated'})",
          flush=True)
    return {"vs_vectorized": gaps, "served_bitwise_vectorized": vec_bits,
            "graph_equals_eager": True, "launches": lg,
            "card_vs_cpu": card_cpu,
            "card_vs_cpu_tol": tol if gated else None,
            "build_s": {"graph": rg.build_time_s, "eager": re_.build_time_s,
                        "vectorized": rv.build_time_s}}


def fused_parity_phase(device="cuda", reference="cpu"):
    """11(a): `_fused_case` for the reference's fused configurations, then
    `churn-afl-gossip-mtd`'s and `comm-qsgd-hfl-fused`'s."""
    from repro_torch.core import scenarios
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.data.synthetic import mnist_like

    ds = mnist_like(**FUSED_DS)
    report = {}
    for label, kw in FUSED_CASES.items():
        def make(engine, d, kw=kw):
            return FederatedSimulation(
                FLConfig(engine=engine, **dict(FUSED_CFG, **kw)), ds,
                device=d)
        report[label] = _fused_case(label, make, device, reference)
    for name in FUSED_REGISTRATION_CASES:
        spec = scenarios.get(name)

        def make(engine, d, spec=spec):
            return scenarios.resolve(dataclasses.replace(spec, engine=engine),
                                     d)
        report[name] = _fused_case(name, make, device, reference,
                                   codec=spec.codec != "none")
    return report


def fused_document_phase(device="cuda"):
    """11(b): the 4 fused registrations through `run_scenario`, each held
    to `_check_document`; on the card `fedavg_agg` must launch in every
    run whose aggregation is a weighted mean (all but the median run,
    whose rounds and served model reduce through `trimmed_mean_agg`
    alone, in the reference too), `trimmed_mean_agg` in the median run,
    `gossip_mix_agg` in the churn-gossip run, and `dequant_agg` in none.
    The launches gated are those a profile of the build window
    (`obs.collectors.device_window`) counts on the device, where no
    wrapper is called: the replayed graph's. Each such kernel's wrapper
    must also have been called in the run (the warmup and the capture)."""
    from repro_torch.core import scenarios
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.obs import collectors

    out = {}
    for name in scenarios.FUSED_SCENARIOS:
        before = FederatedSimulation._kernel_launches()
        box = {}
        t0 = time.perf_counter()
        doc = scenarios.run_scenario(
            name, device=device,
            build_hook=(collectors.device_window(box) if device == "cuda"
                        else None))
        calls = {k: v - before[k] for k, v in
                 FederatedSimulation._kernel_launches().items()}
        _check_document(name, doc)
        want = {"fedavg_agg": scenarios.get(name).defense != "median",
                "trimmed_mean_agg": name == "attack-signflip-median-fused",
                "gossip_mix_agg": name == "churn-afl-gossip-mtd"}
        got = box.get("kernels")
        if device == "cuda" and (
                any(not (got[k] > 0 and calls[k] > 0)
                    for k, v in want.items() if v)
                or got["dequant_agg"] or calls["dequant_agg"]
                or any(box["wrapper_calls"].values())):
            raise SystemExit(
                f"{name}: kernels replayed {got}, wrapper calls in the run "
                f"{calls}, in the build window {box['wrapper_calls']} (want "
                f"> 0: {[k for k, v in want.items() if v]}, dequant_agg 0, "
                f"no call in the build window)")
        m, t = doc["metrics"], doc["timing"]
        print(f"  {name}: test_acc={m['test_accuracy']:.4f} "
              f"f1={m['f1']:.4f} build={t['build_time_s']:.4f}s "
              f"rounds_per_s={t['rounds_per_s']:.2f} (profiled window) "
              f"replayed launches "
              f"{got} (profiled); wrapper calls {calls} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        out[name] = {"metrics": m, "timing": t, "launches": got,
                     "wrapper_calls": calls}
    return out


def serve_trace_phase(device="cuda"):
    """11(c): the serving registrations and the trace demo through
    `run_scenario`. Fails unless every document passes `_check_document`,
    every request of a serving block is completed or shed, the serving
    block of `serve-iid-fused` is byte for byte its vectorized twin's,
    and the trace of `obs-trace-fused-16c` passes
    `validate_chrome_trace`."""
    from repro_torch.core import scenarios
    from repro_torch.obs import validate_chrome_trace

    out = {}
    trace_path = ROOT / "chiprun_out" / "trace_obs_fused_16c.json"
    trace_path.parent.mkdir(exist_ok=True)
    for name in scenarios.SERVE_SCENARIOS + (scenarios.TRACE_DEMO,):
        t0 = time.perf_counter()
        trace = name == scenarios.TRACE_DEMO
        doc = scenarios.run_scenario(
            name, device=device, trace_out=str(trace_path) if trace else None)
        _check_document(name, doc)
        s = doc["serving"]
        row = {"metrics": doc["metrics"], "serving": s}
        if s is not None and s["completed"] + s["shed"] != s["requests"]:
            raise SystemExit(f"{name}: serving block loses requests {s}")
        if name == "serve-iid-fused":
            twin = dataclasses.replace(scenarios.get(name),
                                       engine="vectorized")
            vs = scenarios.run_scenario(twin, device=device)["serving"]
            if json.dumps(vs) != json.dumps(s):
                raise SystemExit(f"{name}: serving block differs from its "
                                 f"vectorized twin's:\n{s}\n{vs}")
            row["serving_equals_vectorized"] = True
        if trace:
            errors = validate_chrome_trace(json.loads(trace_path.read_text()))
            if errors:
                raise SystemExit(f"{name}: invalid Chrome trace {errors[:5]}")
            row["trace_events"] = len(json.loads(
                trace_path.read_text())["traceEvents"])
        print(f"  {name}: test_acc={doc['metrics']['test_accuracy']:.4f}"
              + ("" if s is None else
                 f" requests={s['requests']} shed={s['shed']} "
                 f"p99={s['latency_ms']['p99']:.2f}ms "
                 f"served_acc={s['served_accuracy']} "
                 f"swaps={s['swap_count']}")
              + (f" serving == vectorized twin's"
                 if "serving_equals_vectorized" in row else "")
              + (f" trace valid ({row['trace_events']} events)"
                 if trace else "")
              + f" ({time.perf_counter() - t0:.1f}s)", flush=True)
        out[name] = row
    return out


RATE_REPEATS = 5


def _spread(xs):
    import statistics
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "runs": list(xs)}


def fused_rate_phase(device="cuda", repeats=RATE_REPEATS):
    """11(d), printed and not gated: rounds per second of the build window
    under the fused graph, the fused eager loop and the vectorized engine,
    for `iid-hfl-fused` (8 clients, 2 rounds), the same at 20 rounds (a
    2-round window is mostly the replay launches and the final transfer),
    and an AFL star at 64 clients (participation 1, 64 training images a
    client, batch 32, 5 rounds). Each engine runs `repeats` times, the
    three interleaved in every repeat; a rate is reported as the median
    with its range, a ratio as the median and range of the repeats'
    ratios. Beside each, the device idle share of one more, profiled run
    (`obs.collectors.device_window`)."""
    from repro_torch.core import scenarios
    from repro_torch.obs import collectors

    hfl = scenarios.get("iid-hfl-fused")
    hfl20 = dataclasses.replace(hfl, name="iid-hfl-fused-20r", rounds=20)
    star64 = scenarios.ScenarioSpec(
        "afl-star-64c-fused", "AFL star at 64 clients (rate probe)",
        strategy="afl", topology="star", engine="fused", num_clients=64,
        participation=1.0, n_train=64 * 64, rounds=5, local_batch_size=32)
    modes = ("graph", "eager", "vectorized")

    def once(spec, mode, hook=None):
        sim = scenarios.resolve(dataclasses.replace(
            spec, engine="vectorized" if mode == "vectorized" else "fused"),
            device)
        sim.build_hook = hook
        r = sim.run_fused(graph=False) if mode == "eager" else sim.run()
        return spec.rounds / r.build_time_s

    def fmt(d):
        return f"{d['median']:.2f} [{d['min']:.2f}, {d['max']:.2f}]"

    out = {}
    for spec in (hfl, hfl20, star64):
        rates = {m: [] for m in modes}
        for _ in range(repeats):
            for m in modes:
                rates[m].append(once(spec, m))
        row = {}
        for m in modes:
            box = {}
            if device == "cuda":
                once(spec, m, collectors.device_window(box))
            box.pop("kernels", None)
            box.pop("wrapper_calls", None)
            row[m] = {"rounds_per_s": _spread(rates[m]), **box}
        for other in ("vectorized", "eager"):
            row[f"graph_over_{other}"] = _spread(
                [g / o for g, o in zip(rates["graph"], rates[other])])
        print(f"  {spec.name} ({spec.num_clients} clients, {spec.rounds} "
              f"rounds; median [min, max] of {repeats} runs): " + "; ".join(
                  f"{m} {fmt(row[m]['rounds_per_s'])} rounds/s (profiled "
                  f"run: device busy {row[m].get('device_busy_ms')} of "
                  f"{row[m].get('wall_ms')} ms, "
                  f"{row[m].get('device_events')} device events, idle share "
                  f"{row[m].get('idle_share')})"
                  for m in modes)
              + f"; graph/vectorized {fmt(row['graph_over_vectorized'])}x, "
              f"graph/eager {fmt(row['graph_over_eager'])}x", flush=True)
        out[spec.name] = row
    return out


# -- phase 14 ----------------------------------------------------------------

# the reference's mesh-parity configurations (tests/test_mesh_fused.py:57-67)
# at 16 clients, with the churn case of tests/test_torch_mesh_fused.py
MESH_DS = dict(seed=0, n_train=1024, n_test=256)
MESH_CFG = dict(num_clients=16, rounds=3, num_groups=8, local_epochs=1,
                local_batch_size=16, lr=0.05, seed=0, participation=1.0,
                engine="fused", attack_fraction=0.25, attack_scale=0.5)
MESH_CASES = {
    "hfl": dict(strategy="hfl"),
    "afl-star": dict(strategy="afl"),
    "afl-gossip": dict(strategy="afl", afl_mode="gossip"),
    "hfl-gauss": dict(strategy="hfl", attack="gauss"),
    "afl-chunked": dict(strategy="afl", fused_chunk=1),
    "hfl-churn": dict(strategy="hfl", fault_profile="churn", churn_rate=0.4),
}
# 14(b) gates every configuration against the single-device run trained in
# stacks of the ranks' size and, but for these, against the unchunked run
# too. These miss the unchunked gate on the card (an NVIDIA H100 80GB
# HBM3 at 700 W: AFL star 1.95e-3 round accuracy and 7.8e-3 test
# accuracy, AFL gossip 9.8e-4 / 7.8e-3): the chunked
# single-device run lands as far, and so does a one-rank mesh of the whole
# stack (ROADMAP §C.4). Their unchunked gaps are printed.
MESH_UNCHUNKED_EXCEPTIONS = ("afl-star", "afl-gossip", "afl-chunked")
MESH_RANKS = 8              # ranks sharing the card in 14(b) and 14(d)
MESH_OP_RANKS = 4           # 14(a)
MESH_OP_ERR = 1e-4          # against the host aggregate (the reference's)
MESH_REPLICATED = 1e-5      # every rank holds the same global model
# 14(d): DESIGN.md §11's chunking scale (benchmarks/kernel_bench.py's
# measure_fused_chunked: 8 images a client, batch 8)
MESH_SCALE = dict(strategy="afl", num_clients=1024, participation=1.0,
                  rounds=2, local_epochs=1, local_batch_size=8, lr=0.05,
                  seed=0, engine="fused", fused_chunk=32)
MESH_SCALE_DS = dict(seed=0, n_train=1024 * 8, n_test=128)
# preconditions that must raise before any rank starts (the reference's
# tests/test_mesh_fused.py:150-205, and NCCL asked for 8 ranks on a card)
MESH_REFUSALS = (("cfl", dict(strategy="cfl"), "supports_mesh"),
                 ("defense", dict(defense="median"), "defense"),
                 ("partial", dict(participation=0.5), "full participation"),
                 ("indivisible", dict(mesh_devices=3), "equal shards"),
                 ("groups", dict(strategy="hfl", num_groups=2),
                  "aligned to shards"),
                 ("chunk", dict(fused_chunk=3), "fused_chunk"),
                 ("nccl-shared", dict(mesh_backend="nccl"), "nccl"))


def _mesh_host(op, x, w, kw, device):
    """The host aggregate of one 14(a) case on the card, from the port's
    single-device operators."""
    import torch
    from repro_torch.core import aggregation as agg
    from repro_torch.core import topology

    if op == "fedavg":
        return agg.fedavg_stacked({"w": x}, w)["w"]
    if op == "hfl":
        return agg.hfl_aggregate_stacked({"w": x}, kw["groups"], w)["w"]
    if op == "gossip":
        return agg.gossip_stacked(
            {"w": x}, topology.ring_neighbors(x.shape[0], 2))["w"]
    if op == "model-hfl":
        return agg.hfl_aggregate_stacked(
            {"w": x}, kw.get("groups", kw.get("pod", (0,))[0]), w)["w"]
    if op == "afl_gossip":
        return (torch.roll(x, 1, 0) + x + torch.roll(x, -1, 0)) / 3.0
    if op == "afl_fedavg":
        return agg.afl_aggregate_stacked(
            {"w": x}, w, torch.as_tensor(kw["participate"],
                                         device=device))["w"]
    if op == "cfl":
        mean = agg.fedavg_stacked({"w": x}, w)
        g = agg.cfl_merge({"w": torch.as_tensor(kw["global"],
                                                device=device)},
                          mean, kw["alpha"])
        clients = torch.stack([agg.cfl_merge({"w": row}, g, kw["alpha"])["w"]
                               for row in x])
        return {"global": g["w"], "w": clients}
    raise ValueError(op)


def mesh_operator_phase(device="cuda", ranks=MESH_OP_RANKS):
    """14(a): every mesh operator case of tests/test_torch_mesh.py on
    `ranks` ranks sharing the card (gloo over CUDA tensors; the rank
    halves are tests/torch_mesh_cases.py), against the host aggregate of
    the gathered stack on the card, at the reference tests' tolerances
    (replicated to 1e-5, error below 1e-4), at the paper CNN's width. HFL's
    tier 1 must issue no collective on any rank."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_mesh_cases as cases
    from repro_torch.launch import mesh

    C, N = 16, 7900
    rng = np.random.default_rng(0)
    stacked = rng.normal(size=(C, N)).astype(np.float32)
    weights = rng.uniform(10.0, 100.0, C).astype(np.float32)
    from repro_torch.core import aggregation as agg
    from repro_torch.core import topology
    mix = agg.gossip_mix_matrix(topology.ring_neighbors(C, 2))
    stacked_cases = ([("fedavg", {}), ("gossip", dict(mix=mix))]
                     + [("hfl", dict(groups=g, fallback=f))
                        for g in (8, 4, 2) for f in (False, True)])
    model_cases = [("hfl", dict(groups=2)), ("hfl", dict(groups=2,
                                                         fallback=True)),
                   ("hfl", dict(groups=4)), ("hfl", dict(pod=(2, 2))),
                   ("afl_gossip", {}),
                   ("afl_fedavg", dict(participate=np.array(
                       [1, 0, 1, 1], np.float32))),
                   ("afl_fedavg", dict(participate=np.array(
                       [1, 0, 1, 1], np.float32), pod=(2, 2))),
                   ("cfl", {"global": stacked[ranks], "alpha": 0.3})]
    out = {}
    t0 = time.perf_counter()
    with mesh.World(ranks, device=device) as world:
        start_s = time.perf_counter() - t0
        print(f"  {ranks} ranks on {device}, backend {world.backend}, "
              f"started in {start_s:.1f}s", flush=True)
        for op, kw in stacked_cases + [("tier1", dict(groups_local=2))]:
            outs = world.run(cases.stacked_op, op, stacked, weights, **kw)
            label = op + "".join(f"-{k}{v}" for k, v in kw.items()
                                 if k != "mix")
            counts = [c for _, c in outs]
            if op == "tier1":
                bad = [c for c in counts
                       if any(k.startswith("tier1/") for k in c["calls"])
                       or not c["calls"].get("tier2/all_reduce")]
                if bad:
                    raise SystemExit(f"mesh {label}: tier 1 issued a "
                                     f"collective (or tier 2 none): {bad}")
                out[label] = {"tier1_collectives": 0,
                              "tier2_collectives": [
                                  c["calls"]["tier2/all_reduce"]
                                  for c in counts]}
                print(f"  {label}: tier 1 issued no collective on any rank, "
                      f"tier 2 {out[label]['tier2_collectives']}", flush=True)
                continue
            x = torch.as_tensor(stacked, device=device)
            w = torch.as_tensor(weights, device=device)
            want = _mesh_host(op, x, w, kw, device).cpu().numpy()
            if op == "gossip":
                got, spread = np.concatenate([o["w"] for o, _ in outs]), 0.0
            else:
                got = outs[0][0]["w"]
                spread = max(float(np.abs(o["w"] - got).max())
                             for o, _ in outs)
            err = float(np.abs(got - want).max())
            if not (err < MESH_OP_ERR and spread <= MESH_REPLICATED):
                raise SystemExit(f"mesh {label}: error {err} (limit "
                                 f"{MESH_OP_ERR}), spread over ranks "
                                 f"{spread}")
            out[label] = {"max_abs_err": err, "rank_spread": spread,
                          "calls": counts[0]["calls"]}
            print(f"  stacked {label}: |mesh - host| {err:.3g}, ranks agree "
                  f"to {spread:.3g}, collectives {counts[0]['calls']}",
                  flush=True)
        for op, kw in model_cases:
            outs = world.run(cases.model_op, op, stacked[:ranks],
                             weights[:ranks], **kw)
            label = op + "".join(f"-{k}{v}" for k, v in kw.items()
                                 if k in ("groups", "fallback", "pod"))
            x = torch.as_tensor(stacked[:ranks], device=device)
            w = torch.as_tensor(weights[:ranks], device=device)
            host = _mesh_host("model-hfl" if op == "hfl" else op, x, w, kw,
                              device)
            if op == "cfl":
                want_g = host["global"].cpu().numpy()
                want = host["w"].cpu().numpy()
                got = np.stack([o["w"] for o, _ in outs])
                err = max(float(np.abs(got - want).max()),
                          max(float(np.abs(o["global"] - want_g).max())
                              for o, _ in outs))
                spread = 0.0
            elif op == "afl_gossip":
                got = np.stack([o["w"] for o, _ in outs])
                err = float(np.abs(got - host.cpu().numpy()).max())
                spread = 0.0
            else:
                got = outs[0][0]["w"]
                err = float(np.abs(got - host.cpu().numpy()).max())
                spread = max(float(np.abs(o["w"] - got).max())
                             for o, _ in outs)
            if not (err < MESH_OP_ERR and spread <= MESH_REPLICATED):
                raise SystemExit(f"mesh {label}: error {err}, spread {spread}")
            out["model " + label] = {"max_abs_err": err,
                                     "rank_spread": spread}
            print(f"  one model a rank, {label}: |mesh - host| {err:.3g}, "
                  f"ranks agree to {spread:.3g}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    out["start_s"] = start_s
    return out


def _mesh_gaps(a, b):
    import numpy as np
    return {k: float(np.max(np.abs(np.asarray(getattr(a, k), np.float64)
                                   - np.asarray(getattr(b, k), np.float64))))
            for k in FUSED_TOL}


def _mesh_served_gap(a, b):
    import numpy as np
    return max(float(np.abs(x.cpu().double().numpy()
                            - y.cpu().double().numpy()).max())
               for x, y in zip(_served_leaves(a), _served_leaves(b)))


def _mesh_same(ra, sa, rb, sb):
    import numpy as np
    return (all(np.array_equal(np.asarray(getattr(ra, k)),
                               np.asarray(getattr(rb, k)), equal_nan=True)
                for k in _RESULT_FIELDS)
            and (ra.confusion == rb.confusion).all() and _same_leaves(sa, sb))


def _mesh_pair(label, fl_kw, ds, device, world, tol=FUSED_TOL,
               unchunked=True, **sim_kw):
    """The mesh run of one config on the card and the single-device fused
    graph runs it is gated against, within `tol`; the ranks must launch no
    hand kernel (the mesh path is plain torch ops).

    The first gate's single-device run trains in stacks of the ranks'
    size: with `fused_chunk` 0 it is chunked at C / ranks. On the card
    cuDNN picks a convolution algorithm by shape, so a 2-client stack
    trains to other bits than the 16-client stack (ROADMAP §C.4). With
    `unchunked`, the mesh run is also held to the unchunked single-device
    run, as the reference holds it (tests/test_mesh_fused.py:41-42), but
    for MESH_UNCHUNKED_EXCEPTIONS, whose gap is printed. A world of one
    rank is asked for explicitly (`run_fused(ranks=1)`): `mesh_devices`
    <= 1 is one device."""
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.simulation import FederatedSimulation

    ndev = world.size
    C = fl_kw["num_clients"]
    chunk = fl_kw.get("fused_chunk", 0) or (C // ndev if ndev > 1 else 0)
    single = FederatedSimulation(FLConfig(**dict(fl_kw, fused_chunk=chunk)),
                                 ds, device=device)
    rs = single.run()
    sharded = FederatedSimulation(
        FLConfig(**dict(fl_kw, mesh_devices=ndev if ndev > 1 else 0)), ds,
        device=device, mesh_world=world, **sim_kw)
    t0 = time.perf_counter()
    rm = sharded.run() if ndev > 1 else sharded.run_fused(ranks=1)
    wall = time.perf_counter() - t0
    gaps = _mesh_gaps(rs, rm)
    bad = [k for k in tol if not gaps[k] <= tol[k]]
    rep = sharded.mesh_report
    if bad:
        raise SystemExit(f"mesh {label}: {rep['form']} run on {ndev} "
                         f"{rep['backend']} ranks vs the single-device graph "
                         f"run (fused_chunk={chunk}) beyond the tolerances "
                         f"{bad}: {gaps}")
    if any(sum(k.values()) for k in rep["kernel_launches"]):
        raise SystemExit(f"mesh {label}: a rank launched a hand kernel "
                         f"{rep['kernel_launches']}")
    served = _mesh_served_gap(single, sharded)
    whole = None
    gated = unchunked and label not in MESH_UNCHUNKED_EXCEPTIONS
    if unchunked and chunk:
        whole = _mesh_gaps(FederatedSimulation(
            FLConfig(**dict(fl_kw, fused_chunk=0)), ds,
            device=device).run(), rm)
        bad = [k for k in tol if not whole[k] <= tol[k]]
        if gated and bad:
            raise SystemExit(f"mesh {label}: {rep['form']} run on {ndev} "
                             f"{rep['backend']} ranks vs the unchunked "
                             f"single-device graph run beyond the "
                             f"tolerances {bad}: {whole}")
    print(f"  {label}: {ndev} ranks, backend {rep['backend']}, "
          f"{rep['form']} rounds; vs single-device graph (fused_chunk="
          f"{chunk}) {gaps}; served model |mesh - single| {served:.3g}; "
          + ("" if whole is None else
             f"vs the unchunked single-device run "
             f"({'gated' if gated else 'printed: known exception'}) "
             f"{whole}; ")
          + f"build {rm.build_time_s:.3f}s (single {rs.build_time_s:.3f}s), "
          f"run wall {wall:.1f}s", flush=True)
    return single, rs, sharded, rm, {
        "ranks": ndev, "backend": rep["backend"], "form": rep["form"],
        "single_fused_chunk": chunk, "vs_single": gaps,
        "vs_unchunked_single": whole,
        "unchunked_gated": gated and whole is not None,
        "served_vs_single": served,
        "build_s": rm.build_time_s, "single_build_s": rs.build_time_s,
        "rank_build_s": rep["build_s"], "wall_s": wall,
        "peak_bytes": rep["peak_bytes"]}


def _tier1_local(label, report):
    bad = [(r, c) for r, c in enumerate(report["collectives"])
           if not c["scopes"].get("hfl.tier1")
           or any(k.startswith("hfl.tier1/") for k in c["calls"])
           or not c["calls"].get("hfl.tier2/all_reduce")]
    if bad:
        raise SystemExit(f"mesh {label}: HFL tier 1 issued a collective (or "
                         f"tier 2 none) on ranks {bad}")
    return [c["calls"]["hfl.tier2/all_reduce"] for c in report["collectives"]]


def mesh_executor_phase(device="cuda", ranks=MESH_RANKS, nccl=True,
                        scale=MESH_SCALE):
    """14(b)-(d). (b) the 6 mesh configurations at 16 clients on `ranks`
    ranks sharing the card (gloo, eager rounds) against the single-device
    fused graph run on the card at the reference's tolerances (trained in
    stacks of the ranks' size, see `_mesh_pair`; no hand kernel launched
    in any rank), the HFL run
    repeated bitwise, HFL's tier 1 without a collective on every rank, and
    the preconditions raising; (c) nccl at world 1, the round captured as
    a CUDA graph, within 1e-5 of the single-device graph run on every
    metric, repeated bitwise; (d) 1024 clients, fused_chunk=32, AFL star,
    2 rounds on `ranks` ranks against the single-device chunked graph run,
    with seconds per round and each rank's peak memory (not a speedup: the
    ranks share one card)."""
    import torch
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.launch import mesh

    ds = mnist_like(**MESH_DS)
    out = {"cases": {}}
    t0 = time.perf_counter()
    for name, kw, needle in MESH_REFUSALS:
        kw = dict(kw)
        backend = kw.pop("mesh_backend", None)
        cfg = dict(MESH_CFG, strategy="afl", rounds=1, mesh_devices=ranks)
        cfg.update(kw)
        try:
            FederatedSimulation(FLConfig(**cfg), ds, device=device,
                                mesh_backend=backend).run()
        except ValueError as e:
            if needle not in str(e):
                raise SystemExit(f"mesh refusal {name}: {e}") from e
            continue
        raise SystemExit(f"mesh refusal {name}: no error raised")
    out["refusals_s"] = time.perf_counter() - t0
    print(f"  the {len(MESH_REFUSALS)} preconditions raised before any rank "
          f"started", flush=True)
    with mesh.World(ranks, device=device) as world:
        out["start_s"] = time.perf_counter() - t0 - out.get("refusals_s", 0)
        print(f"  {ranks} ranks on {device}, backend {world.backend}, "
              f"started in {out['start_s']:.1f}s", flush=True)
        print("  -- (b) the mesh configurations against the single-device "
              "graph run", flush=True)
        runs = {}
        for label, kw in MESH_CASES.items():
            runs[label] = _mesh_pair(label, dict(MESH_CFG, **kw), ds, device,
                                     world)
            row = runs[label][4]
            if MESH_CASES[label]["strategy"] == "hfl":
                row["tier2_collectives"] = _tier1_local(
                    label, runs[label][2].mesh_report)
            out["cases"][label] = row
        _, _, s1, r1, _ = runs["hfl"]
        again = FederatedSimulation(
            FLConfig(**dict(MESH_CFG, strategy="hfl", mesh_devices=ranks)),
            ds, device=device, mesh_world=world)
        r2 = again.run()
        if not _mesh_same(r1, s1, r2, again):
            raise SystemExit("mesh hfl: the repeated sharded run differs")
        out["repeat_bitwise"] = True
        print("  hfl: repeated sharded run bitwise equal; tier 1 issued no "
              "collective on any rank", flush=True)
        if nccl:
            print("  -- (c) nccl at world 1, the round as a CUDA graph",
                  flush=True)
            with mesh.World(1, device=device, backend="nccl") as one:
                cfg = dict(MESH_CFG, strategy="hfl")
                tol = {k: 1e-5 for k in FUSED_TOL}
                _, _, sa, ra, row = _mesh_pair("hfl-nccl", cfg, ds, device,
                                               one, tol=tol)
                sb = FederatedSimulation(FLConfig(**cfg), ds, device=device,
                                         mesh_world=one)
                rb = sb.run_fused(ranks=1)
            if row["form"] != "graph" or row["backend"] != "nccl":
                raise SystemExit(f"mesh hfl-nccl: ran {row['backend']} "
                                 f"{row['form']}, want nccl graph")
            if not _mesh_same(ra, sa, rb, sb):
                raise SystemExit("mesh hfl-nccl: the repeated run differs")
            row["tier2_collectives"] = _tier1_local("hfl-nccl", sa.mesh_report)
            row["repeat_bitwise"] = True
            out["nccl"] = row
            print("  hfl-nccl: repeated graph run bitwise equal", flush=True)
        C = scale["num_clients"]
        print(f"  -- (d) {C} clients, fused_chunk={scale['fused_chunk']}, "
              f"AFL star, {scale['rounds']} rounds", flush=True)
        big = mnist_like(**dict(MESH_SCALE_DS, n_train=C * 8))
        on_card = device == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _, rs, _, rm, row = _mesh_pair(f"afl-{C}c-chunk{scale['fused_chunk']}",
                                       scale, big, device, world,
                                       unchunked=False)
        R = scale["rounds"]
        row.update(single_s_per_round=rs.build_time_s / R,
                   mesh_s_per_round=rm.build_time_s / R,
                   caller_peak_bytes=(torch.cuda.max_memory_allocated()
                                      if on_card else None))
        mb = [None if b is None else round(b / 2**20, 1)
              for b in row["peak_bytes"] + [row["caller_peak_bytes"]]]
        print(f"  afl-{C}c: seconds per round single-device graph "
              f"{row['single_s_per_round']:.4f}, {ranks} ranks sharing the "
              f"card ({row['backend']}, {row['form']}) "
              f"{row['mesh_s_per_round']:.4f} (not a speedup: one card); "
              f"rank peak memory (MB) {mb[:-1]}; caller peak {mb[-1]} MB",
              flush=True)
        out["scale"] = row
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 15 ----------------------------------------------------------------

SHARDED_RANKS = 8                     # ranks sharing the card (gloo)
SHARDED_MESH = ((4, 2), ("data", "model"))
SHARDED_REL = 1e-5                    # loss and grad-norm, relative
SHARDED_PARAM_ATOL = 1e-6             # params after the SGD steps
SHARDED_FL_TOL = 1e-5                 # FL loss (relative) and params
SHARDED_DECODE_ATOL = 1e-4            # decode rows
SHARDED_PREFILL_REL = 1e-3            # of the prefill's max |logit| (9(c))
# the reference test's four (arch, profile) pairs, reduced with vocab 512
# (tests/test_sharding_and_dryrun.py:110-115)
SHARDED_PAIRS = (("phi3-mini-3.8b", "tp"), ("qwen3-moe-30b-a3b", "tp"),
                 ("zamba2-1.2b", "fsdp"), ("xlstm-125m", "dp"))


def _zamba_cut_kw(**kw):
    layers = TRAIN_CUT["num_layers"][1]
    return dict(dtype="float32", num_layers=layers,
                block_pattern=("mamba",) * layers, sharding_profile="fsdp",
                **kw)


def _np_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _mb(report):
    b = report["peak_bytes"]
    return None if b is None else round(b / 2**20, 1)


def _sharded_train_case(world, label, arch, kw, B, S, reduced, device,
                        gated_all_gather=False):
    """One config: 2 SGD steps (lr 1e-2) and 1 AdamW step of
    `make_sharded_train_step` on the ranks against `make_train_step` on
    the card from one init (seed 0) and batch (seed 1)."""
    import numpy as np
    import torch
    import torch_sharded_cases as cases
    from repro_torch.device import generator
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import synthetic_train_batch
    from repro_torch.optim import optimizers
    from repro_torch.tree import tree_leaves

    model = cases.build(arch, reduced, **kw)
    batch = synthetic_train_batch(generator(1), model.cfg, B, S,
                                  device="cpu")
    bnp = {k: v.numpy() for k, v in batch.items()}
    bdev = {k: v.to(device) for k, v in batch.items()}
    out = {"B": B, "S": S}

    def single(opt, steps):
        p = model.init(generator(0), device)
        s, ms, times = opt.init(p), [], []
        step = make_train_step(model, opt)
        for _ in range(steps):
            (p, s, m), t = _timed(lambda: step(p, s, bdev))
            times.append(t / 1e3)
            ms.append({k: float(v) for k, v in m.items()})
        return [x.cpu().numpy() for x in tree_leaves(p)], ms, times

    for name, opt, kind, lr, steps in (
            ("sgd", optimizers.sgd(1e-2), "sgd", 1e-2, 2),
            ("adamw", optimizers.adamw(3e-4, weight_decay=0.01), "adamw",
             3e-4, 1)):
        want_p, want_m, single_s = single(opt, steps)
        with tempfile.TemporaryDirectory() as tmp:
            outs = world.run(cases.train, arch, kw, *SHARDED_MESH, bnp,
                             opt=kind, lr=lr, steps=steps, reduced=reduced,
                             repeat=name == "sgd", out_dir=tmp)
            full = cases.load(outs[0][0])
        _, metrics, rep0 = outs[0]
        rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                  for g, w in zip(metrics, want_m)
                  for k in ("loss", "grad_norm"))
        perr = max(float(np.abs(a - b).max()) for a, b in zip(full, want_p))
        kinds = rep0["collectives"]["kinds"]
        launches = [sum(r["launches"].values()) for *_, r in outs]
        repeat = all(r.get("bitwise_repeat", True) for *_, r in outs)
        agree = all(o[1] == metrics for o in outs)
        row = {"metrics": metrics, "rel": rel, "param_max_abs_err": perr,
               "collectives": kinds, "launches": launches,
               "bitwise_repeat": repeat if name == "sgd" else None,
               "ranks_agree": agree,
               "rank_step_s": [r["step_seconds"] for *_, r in outs],
               "single_step_s": single_s,
               "rank_peak_mb": [_mb(r) for *_, r in outs]}
        out[name] = row
        print(f"  {label} {name}: loss {metrics[-1]['loss']:.6f} "
              f"grad-norm {metrics[-1]['grad_norm']:.6f}; rel {rel:.2e}; "
              f"params max|d| {perr:.3e}"
              f"{'' if name == 'sgd' else ' (printed)'}; repeat "
              f"{row['bitwise_repeat']}; s/step ranks "
              f"{[round(t, 3) for t in rep0['step_seconds']]} single "
              f"{[round(t, 3) for t in single_s]}; collectives {kinds}; "
              f"rank peak MB {row['rank_peak_mb']}", flush=True)
        bad = (rel > SHARDED_REL or not agree or any(launches)
               or (name == "sgd" and (perr > SHARDED_PARAM_ATOL
                                      or not repeat))
               or not sum(kinds.values())
               or (gated_all_gather and not kinds.get("all-gather")))
        if bad:
            raise SystemExit(f"15(a) {label} {name}: {row}")
        del full, outs
        torch.cuda.empty_cache()
    return out


def sharded_train_phase(world, device="cuda", B=8, S=256):
    """15(a): zamba2-1.2b at full width cut 38 -> 7 as in 13(a) (float32,
    fsdp, B x S = 8 x 256), then the reference test's four (arch,
    profile) pairs reduced (8 x 64): 2 SGD and 1 AdamW steps sharded over
    the ranks against `make_train_step` on the card."""
    from repro_torch.device import deterministic_f32
    deterministic_f32()
    out = {"zamba2-1.2b-cut": _sharded_train_case(
        world, "zamba2-1.2b cut 38 -> 7 (fsdp)", ZAMBA, _zamba_cut_kw(), B,
        S, False, device, gated_all_gather=True)}
    for arch, profile in SHARDED_PAIRS:
        out[f"{arch}-{profile}"] = _sharded_train_case(
            world, f"{arch} reduced ({profile})", arch,
            dict(dtype="float32", sharding_profile=profile, vocab_size=512),
            8, 64, True, device)
    return out


def sharded_fl_phase(world, device="cuda", C=4, K=2, B=2, S=64, rounds=2):
    """15(b): the reference's FL-mesh test config (phi3-mini reduced,
    vocab 512, float32; 4 clients in 2 groups, K = 2, lr 0.05), 2 rounds
    of each strategy on the ranks (one client a "data" rank) against the
    one-device `FederatedTrainer` on the card."""
    import numpy as np
    import torch
    import torch_sharded_cases as cases
    from repro_torch.core.fl_types import FLConfig
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.tree import tree_leaves, tree_map

    deterministic_f32()
    arch, kw = "phi3-mini-3.8b", dict(dtype="float32", vocab_size=512)
    model = cases.build(arch, **kw)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(rounds):
        toks = rng.integers(0, 512, (C, K, B, S), dtype=np.int64)
        labels = np.concatenate([toks[..., 1:],
                                 np.full((C, K, B, 1), -1, np.int64)], -1)
        batches.append({"tokens": toks, "labels": labels})
    w = rng.integers(5, 50, C).astype(np.float32)
    part = np.array([True, False, True, True])
    out = {}
    for case, fl_case in FL_TRAIN_CASES.items():
        fl_kw = dict(fl_case, num_clients=C, num_groups=2, local_steps=K,
                     lr=0.05)
        tr = FederatedTrainer(model, FLConfig(**fl_kw))
        state = tr.init_state(generator(0), device=device)
        t0 = time.perf_counter()
        losses = []
        for b in batches:
            state, m = tr.fl_train_step(
                state, {k: torch.as_tensor(v, device=device)
                        for k, v in b.items()},
                torch.as_tensor(w, device=device),
                torch.as_tensor(part, device=device))
            losses.append(float(m["loss"]))
        single_s = (time.perf_counter() - t0) / rounds
        outs = world.run(cases.fl, arch, kw, fl_kw, *SHARDED_MESH, batches,
                         w, part, repeat=True)
        err, lerr = 0.0, 0.0
        for (lo, hi), _, mine, glob, got, rep in outs:
            lerr = max(lerr, max(abs(a - b) / abs(b)
                                 for a, b in zip(got, losses)))
            one = tree_map(lambda x: x[lo:hi], state["client_params"])
            err = max([err] + [float(np.abs(a - b.cpu().numpy()).max())
                               for a, b in zip(tree_leaves(mine),
                                               tree_leaves(one))])
            if glob is not None:
                err = max([err] + [
                    float(np.abs(a - b.cpu().numpy()).max())
                    for a, b in zip(tree_leaves(glob),
                                    tree_leaves(state["global_params"]))])
        reps = [r for *_, r in outs]
        kinds = reps[0]["collectives"]["kinds"]
        row = {"loss": losses, "loss_rel": lerr, "param_max_abs_err": err,
               "bitwise_repeat": all(r["bitwise_repeat"] for r in reps),
               "collectives": [r["collectives"]["kinds"] for r in reps],
               "launches": [sum(r["launches"].values()) for r in reps],
               "rank_s_per_round": [r["seconds"] / rounds for r in reps],
               "single_s_per_round": single_s,
               "rank_peak_mb": [_mb(r) for r in reps]}
        out[case] = row
        print(f"  {case}: loss {losses}; rel {lerr:.2e}, params max|d| "
              f"{err:.3e}, repeat {row['bitwise_repeat']}; collectives "
              f"{kinds}; s/round ranks {max(row['rank_s_per_round']):.3f} "
              f"single {single_s:.3f}; rank peak MB {row['rank_peak_mb']}",
              flush=True)
        if (lerr > SHARDED_FL_TOL or err > SHARDED_FL_TOL
                or not row["bitwise_repeat"] or any(row["launches"])
                or not all(sum(k.values()) for k in row["collectives"])
                or (case == "afl-gossip" and not all(
                    k.get("collective-permute") for k in row["collectives"]))):
            raise SystemExit(f"15(b) {case}: {row}")
    return out


def sharded_serve_phase(world, device="cuda", B=8, S=2048, steps=16):
    """15(c): zamba2-1.2b cut 38 -> 7 (float32, fsdp, attn_impl="flash"),
    the kernel prefill of B x S = 8 x 2048 tokens and 16 teacher-forced
    decode steps sharded over the ranks (each rank its rows) against the
    single-device kernel prefill and decode on the card; B5 and B6 must
    launch in every rank, as often as in the single-device prefill."""
    import numpy as np
    import torch
    import torch_sharded_cases as cases
    from repro_torch.device import deterministic_f32, generator

    deterministic_f32()
    kw = _zamba_cut_kw(attn_impl="flash")
    model = cases.build(ZAMBA, False, **kw)
    params = model.init(generator(0), device)
    tokens = torch.randint(0, model.cfg.vocab_size, (B, S),
                           generator=generator(1))
    tok = tokens.to(device)
    with torch.no_grad():
        before = _counts()
        logits, prefill_ms = _timed(lambda: kernel_prefill(model, params,
                                                           tok))
        single_launches = _delta(before)
        dec, decode_ms = _timed(lambda: _decode(model, params, tok, steps,
                                                device))
    logits = logits.float().cpu().numpy()
    dec = dec.float().transpose(0, 1).cpu().numpy()      # (steps, B, V)
    del params
    torch.cuda.empty_cache()
    scale, perr = float(np.abs(logits).max()), 0.0
    with tempfile.TemporaryDirectory() as tmp:
        outs = world.run(cases.serve, ZAMBA, kw, *SHARDED_MESH,
                         tokens.numpy(), steps, kernel=True, reduced=False,
                         out_dir=tmp)
        for (a, b), lg, *_ in outs:
            perr = max(perr, float(np.abs(cases.load(lg)[0]
                                          - logits[a:b]).max()))
    derr = max(float(np.abs(d - dec[:, c:e]).max())
               for _, _, (c, e), d, _ in outs)
    reps = [o[4] for o in outs]
    launches = [r["launches"] for r in reps]
    out = {"B": B, "S": S, "decode_steps": steps,
           "prefill_max_abs_err": perr, "prefill_max_abs": scale,
           "decode_max_abs_err": derr, "launches": launches,
           "single_launches": single_launches,
           "single_prefill_s": prefill_ms / 1e3,
           "single_decode_s_per_step": decode_ms / 1e3 / steps,
           "rank_prefill_s": [r["prefill_seconds"] for r in reps],
           "rank_decode_s_per_step": [r["decode_seconds"] / steps
                                      for r in reps],
           "rank_peak_mb": [_mb(r) for r in reps],
           "collectives": reps[0]["collectives"]["kinds"]}
    print(f"  prefill |sharded - single| {perr:.3e} (bar "
          f"{SHARDED_PREFILL_REL} x {scale:.3f}); decode {derr:.3e}; "
          f"launches a rank {launches[0]} (single device {single_launches});"
          f" prefill s ranks {max(out['rank_prefill_s']):.3f} single "
          f"{out['single_prefill_s']:.3f}; decode s/step ranks "
          f"{max(out['rank_decode_s_per_step']):.3f} single "
          f"{out['single_decode_s_per_step']:.4f}; rank peak MB "
          f"{out['rank_peak_mb']}", flush=True)
    if not (perr <= SHARDED_PREFILL_REL * scale
            and derr <= SHARDED_DECODE_ATOL):
        raise SystemExit(f"15(c): prefill {perr} or decode {derr} off")
    if not (all(l["flash_attention"] > 0 and l["ssm_scan"] > 0
                for l in launches)
            and all(l == launches[0] for l in launches)
            and launches[0]["flash_attention"]
            >= single_launches["flash_attention"]
            and launches[0]["ssm_scan"] >= single_launches["ssm_scan"]):
        raise SystemExit(f"15(c): kernel launches {launches}, single "
                         f"device {single_launches}")
    return out


DRYRUN_FL = (("hfl", "fedavg"), ("afl", "fedavg"), ("afl", "gossip"),
             ("cfl", "fedavg"))
# the dry-runs that fit the script's time limit; the whole sweep (every
# config at train_4k, yi-9b at all four shapes on both meshes: ~17 min,
# xlstm's sLSTM loop alone 603 s) runs through the CLI (PERF.md §5)
DRYRUN_SHAPES = ("decode_32k", "long_500k")


def dryrun_phase():
    """15(d): the port's dry-run on the meta device (no card), at full
    size: each FL strategy over phi3-mini on 16x16, and yi-9b's decode
    shapes on 16x16 and 2x16x16. Each must return ok with FLOPs and
    collectives."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun

    jobs = ([("fl", "phi3-mini-3.8b", f, m) for f, m in DRYRUN_FL]
            + [("std", "yi-9b", s, mp) for s in DRYRUN_SHAPES
               for mp in (False, True)])
    out = []
    t0 = time.perf_counter()
    for kind, arch, what, extra in jobs:
        if kind == "fl":
            r = dryrun.lower_fl(arch, what, afl_mode=extra)
            profile = "tp"
        else:
            r = dryrun.lower_and_compile(arch, what, multi_pod=extra)
            profile = get_config(arch).sharding_profile
        roof = r["roofline"]
        if not (r["ok"] and roof["flops_per_device"] > 0
                and roof["collective_count"] > 0):
            raise SystemExit(f"15(d) {arch} {what} {extra}: {r}")
        r["profile"] = profile
        out.append(r)
    print(f"  {len(out)} dry-runs in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return out


def sharded_phase(device="cuda"):
    """15(a)-(c) on one world of SHARDED_RANKS ranks sharing the card,
    then 15(d)."""
    from repro_torch.launch import mesh
    sys.path.insert(0, str(ROOT / "tests"))
    out = {}
    t0 = time.perf_counter()
    with mesh.World(SHARDED_RANKS, device=device, timeout=600) as world:
        print(f"  {SHARDED_RANKS} ranks on {device}, backend "
              f"{world.backend}, mesh {SHARDED_MESH}, started in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        for key, label, fn in (
                ("train", "(a) the sharded train step", sharded_train_phase),
                ("fl", "(b) the sharded federated trainer", sharded_fl_phase),
                ("serve", "(c) the sharded kernel prefill and decode",
                 sharded_serve_phase)):
            print(f"  -- {label} (at {time.perf_counter() - t0:.1f}s)",
                  flush=True)
            out[key] = fn(world, device)
    print(f"  -- (d) the dry-run on the meta device (at "
          f"{time.perf_counter() - t0:.1f}s, the ranks stopped)", flush=True)
    out["dryrun"] = dryrun_phase()
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 16 -----------------------------------------------------------------

GRAPH_STEPS = 16          # steps a timed or profiled run of 16(a)
GRAPH_KINDS = {           # 16(b): kind -> (arch, reduced-config updates)
    "window ring": ("gemma3-4b", dict(num_layers=3, sliding_window=8,
                                      global_every=3)),
    "mla": (MLA, {}),
    "moe": (MOE, dict(capacity_factor=4.0)),      # drop-free: 4 experts
    "mlstm + slstm": (XLSTM, dict(block_pattern=("mlstm", "slstm"))),
}


def _graph_and_eager(model, params, tokens, device):
    """Teacher-forced decode of every column of `tokens` through the
    graphed serve step and through the eager `decode_step`, each from its
    own new state -> (graph logits, eager logits, graph state, eager
    state); the logits are (B, n, V)."""
    import torch
    from repro_torch.launch.serve import make_graphed_serve_step
    B, n = tokens.shape
    gstate = model.init_decode_state(B, n, device=device)
    estate = model.init_decode_state(B, n, device=device)
    step = make_graphed_serve_step(model, params, gstate, tokens[:, :1])
    glog, elog = [], []
    for t in range(n):
        lg, _ = step(params, gstate, tokens[:, t:t + 1])
        glog.append(lg.clone())
        lg, estate = model.decode_step(params, estate, tokens[:, t:t + 1])
        elog.append(lg)
    return torch.cat(glog, 1), torch.cat(elog, 1), gstate, estate


def _states_equal(a, b):
    import torch
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def decode_graph_zamba2_phase(device="cuda", seed=0, B=2):
    """16(a): zamba2-1.2b whole (as 9(c): float32, random weights from a
    seed, B = 2): the graphed serve step's logits over DECODE_STEPS
    teacher-forced steps equal the eager `decode_step`'s bit for bit and
    stay within DECODE_TOL of the prefill; two graphed runs repeat
    bitwise; ms a step of the graph and of the eager step (median of 3
    runs of GRAPH_STEPS steps), the idle share of one profiled run of
    each, and the peak memory."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.launch.serve import (make_graphed_serve_step,
                                          make_prefill_step)
    from repro_torch.models.model import build_model, synthetic_train_batch

    deterministic_f32()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ZAMBA).with_updates(dtype="float32",
                                         attn_impl="einsum")
    model = build_model(cfg)
    params, init_ms = _timed(lambda: model.init(generator(seed), device))
    n_params = model.param_count(params)
    tokens = synthetic_train_batch(generator(seed + 1), cfg, B, DECODE_STEPS,
                                   device=device)["tokens"]
    out = {"config": "zamba2-1.2b, dtype float32, nothing cut",
           "params": n_params, "init_ms": init_ms, "B": B,
           "steps": DECODE_STEPS}
    print(f"  {n_params} parameters, init {init_ms:.0f} ms", flush=True)
    head = make_prefill_step(model)(params, {"tokens": tokens})
    graph, eager, gstate, estate = _graph_and_eager(model, params, tokens,
                                                    device)
    graph2, _, gstate2, _ = _graph_and_eager(model, params, tokens, device)
    err = float((graph - head).abs().max())
    out.update(graph_equals_eager=bool(torch.equal(graph, eager)),
               states_equal=_states_equal(gstate, estate),
               graph_repeat_bitwise=bool(torch.equal(graph, graph2)
                                         and _states_equal(gstate, gstate2)),
               graph_vs_prefill_max_abs_err=err,
               eager_vs_prefill_max_abs_err=float((eager - head).abs().max()),
               index=int(gstate["index"]))
    print(f"  graph vs eager over {DECODE_STEPS} steps: logits bitwise "
          f"{out['graph_equals_eager']}, state bitwise "
          f"{out['states_equal']}; graph vs the prefill {err:.3e} (bar "
          f"{DECODE_TOL}); two graphed runs bitwise "
          f"{out['graph_repeat_bitwise']}; index {out['index']}", flush=True)
    if not (out["graph_equals_eager"] and out["states_equal"]
            and out["graph_repeat_bitwise"] and err <= DECODE_TOL
            and out["index"] == DECODE_STEPS
            and bool(torch.isfinite(graph).all())):
        raise SystemExit("16(a): the graphed decode differs from eager, "
                         "from its repeat or from the prefill")
    del graph, eager, graph2, head, gstate, estate, gstate2

    # steady times: 3 timed runs and 1 profiled run of GRAPH_STEPS steps
    # on one state of each kind (capacity for all four runs)
    cap = 4 * GRAPH_STEPS
    toks = tokens[:, :1]
    gstate = model.init_decode_state(B, cap, device=device)
    step = make_graphed_serve_step(model, params, gstate, toks)
    estate = [model.init_decode_state(B, cap, device=device)]

    def graph_run():
        for _ in range(GRAPH_STEPS):
            step(params, gstate, toks)

    def eager_run():
        for _ in range(GRAPH_STEPS):
            estate[0] = model.decode_step(params, estate[0], toks)[1]

    for name, fn in (("graph", graph_run), ("eager", eager_run)):
        runs = [_timed(fn)[1] / GRAPH_STEPS for _ in range(3)]
        out[f"{name}_ms_per_step_runs"] = runs
        out[f"{name}_ms_per_step"] = statistics.median(runs)
        print(f"  {name} decode at B = {B}: "
              f"{out[f'{name}_ms_per_step']:.3f} ms/step (3 runs of "
              f"{GRAPH_STEPS} steps: {', '.join(f'{r:.3f}' for r in runs)})",
              flush=True)
        prof = _profile(fn) if on_card else None
        out[f"profile {name} x{GRAPH_STEPS}"] = prof
        if prof is None:
            print(f"  profile {name}: no device time recorded (not "
                  f"measured)", flush=True)
            continue
        print(f"  profile {name} x{GRAPH_STEPS}: wall "
              f"{prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.1f} ms, idle share <= "
              f"{prof['idle_share']:.3f}", flush=True)
        for kname, ms, n, share in prof["kernels"]:
            print(f"    {ms:9.2f} ms {n:6d}x {share:6.1%}  {kname}",
                  flush=True)
    out["speedup"] = out["eager_ms_per_step"] / out["graph_ms_per_step"]
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                if on_card else None)
    print(f"  graph {out['speedup']:.2f}x the eager step; peak memory "
          f"{(out['peak_memory_bytes'] or 0) / 2**30:.2f} GiB", flush=True)
    if on_card:
        out["card"] = _card_line()
        print(f"  on {out['card']}", flush=True)
    del params, step, gstate, estate
    if on_card:
        torch.cuda.empty_cache()
    return out


def decode_graph_kinds_phase(device="cuda", B=2, steps=GRAPH_STEPS):
    """16(b): one reduced config per other kind of decode state (float32,
    random weights): the graph against the eager step bit for bit, logits
    and state, over `steps` teacher-forced steps (past the window ring's
    8 slots)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.device import deterministic_f32, generator
    from repro_torch.models.model import build_model

    deterministic_f32()
    out = {}
    for kind, (arch, kw) in GRAPH_KINDS.items():
        cfg = get_config(arch).reduced(dtype="float32", **kw)
        model = build_model(cfg)
        params = model.init(generator(0), device)
        tokens = torch.randint(0, cfg.vocab_size, (B, steps),
                               generator=generator(1)).to(device)
        graph, eager, gstate, estate = _graph_and_eager(model, params,
                                                        tokens, device)
        row = {"arch": arch, "logits_bitwise": bool(torch.equal(graph, eager)),
               "state_bitwise": _states_equal(gstate, estate),
               "finite": bool(torch.isfinite(graph).all()),
               "index": int(gstate["index"])}
        out[kind] = row
        print(f"  {kind} ({arch} reduced): graph vs eager over {steps} "
              f"steps, logits bitwise {row['logits_bitwise']}, state "
              f"bitwise {row['state_bitwise']}", flush=True)
        if not (row["logits_bitwise"] and row["state_bitwise"]
                and row["finite"] and row["index"] == steps):
            raise SystemExit(f"16(b) {kind}: the graphed decode differs "
                             f"from eager")
    return out


def examples_phase(device="cuda"):
    """16(c): the examples' twins in-process through `main(argv)` on the
    card, with the reference test's arguments: the quickstart (the loss
    falls, the checkpoint restores bit for bit), the FL twin three ways
    and once more with gossip under a fault profile (B1 launched in each,
    B3 in the masked gossip of the last, as
    `FederatedSimulation._kernel_launches()` counts them) and
    serve_decode (its tokens equal an eager `greedy_generate`). The
    launch gates are the card's only."""
    import contextlib
    import io

    import torch
    from repro_torch.core.simulation import FederatedSimulation
    from repro_torch.examples import federated_image_classification as fic
    from repro_torch.examples import quickstart, serve_decode
    from repro_torch.models.decode import greedy_generate
    from repro_torch.tree import tree_leaves

    def call(main, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = main(argv + ["--device", device])
        return res, buf.getvalue(), time.perf_counter() - t0

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        qs, text, s = call(quickstart.main, [
            "--arch", "xlstm-125m", "--steps", "8", "--batch", "2",
            "--seq-len", "64", "--ckpt-dir", tmp])
        restored = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(qs["params"]), tree_leaves(qs["restored"])))
        hist = qs["history"]
        out["quickstart"] = {"loss": [hist[0][1], hist[-1][1]],
                             "restored_bitwise": restored,
                             "generated": qs["generated"][0].tolist(),
                             "seconds": s}
        print(f"  quickstart xlstm-125m: loss {hist[0][1]:.3f} -> "
              f"{hist[-1][1]:.3f}, checkpoint restored bitwise {restored}, "
              f"{s:.1f}s", flush=True)
        if not (hist[-1][1] < hist[0][1] and restored
                and "checkpointed -> " in text):
            raise SystemExit("16(c) quickstart: the loss did not fall or the "
                             "checkpoint did not restore")
        fl_runs = (
            ("afl --curves", ["--strategy", "afl", "--dataset", "mnist",
                              "--rounds", "2", "--clients", "4",
                              "--n-train", "400", "--curves", "--outdir",
                              tmp], ("fedavg_agg",)),
            ("fedadam vectorized", ["--strategy", "fedadam", "--rounds", "2",
                                    "--clients", "4", "--n-train", "400",
                                    "--engine", "vectorized",
                                    "--server-lr", "0.1"], ("fedavg_agg",)),
            ("afl --gossip --non-iid", ["--strategy", "afl", "--gossip",
                                        "--non-iid", "--rounds", "2",
                                        "--clients", "4", "--n-train",
                                        "400"], ("fedavg_agg",)),
            # B3 mixes the masked gossip of a fault schedule; the static
            # ring mixes by one plain matmul, as the reference's does
            ("afl --gossip --fault-profile churn",
             ["--strategy", "afl", "--gossip", "--fault-profile", "churn",
              "--rounds", "2", "--clients", "4", "--n-train", "400"],
             ("fedavg_agg", "gossip_mix_agg")))
        for label, argv, needed in fl_runs:
            _reset_launches()
            r, text, s = call(fic.main, argv)
            launches = FederatedSimulation._kernel_launches()
            out[label] = {"test_accuracy": r.test_accuracy,
                          "launches": launches, "seconds": s}
            print(f"  FL twin {label}: test acc {r.test_accuracy:.3f}, "
                  f"launches {launches}, {s:.1f}s", flush=True)
            launched = device != "cuda" or all(launches[k] > 0
                                                for k in needed)
            if not ("testing acc:" in text and launched):
                raise SystemExit(f"16(c) FL twin {label}: no metrics or "
                                 f"{needed} not launched: {launches}")
            if label == "afl --curves" and not os.path.exists(os.path.join(
                    tmp, "curves", "curves_afl_mnist.csv")):
                raise SystemExit("16(c) FL twin: no curves written")
    sd, text, s = call(serve_decode.main, [
        "--arch", "gemma3-4b", "--batch", "2", "--prompt-len", "4",
        "--gen-len", "8"])
    want = greedy_generate(sd["params"], sd["cfg"], sd["prompt"], 8)
    same = bool(torch.equal(sd["tokens"], want))
    out["serve_decode"] = {"tokens_equal_greedy": same, "index": sd["index"],
                           "decode_s": sd["decode_s"], "seconds": s,
                           "lines": text.splitlines()}
    print(f"  serve_decode gemma3-4b reduced, B = 2, 4 + 8 tokens: tokens "
          f"equal greedy_generate {same}, cache index {sd['index']}, "
          f"{s:.1f}s", flush=True)
    for line in text.splitlines():
        print("    | " + line, flush=True)
    if not (same and sd["index"] == 12):
        raise SystemExit("16(c) serve_decode: its tokens differ from "
                         "greedy_generate")
    return out


def decode_graph_phase(device="cuda"):
    """Phase 16: (a), (b), (c) in turn."""
    t0 = time.perf_counter()
    out = {}
    for key, label, fn in (
            ("zamba2", "(a) zamba2-1.2b whole: graph vs eager",
             decode_graph_zamba2_phase),
            ("kinds", "(b) the other decode state kinds, reduced",
             decode_graph_kinds_phase),
            ("examples", "(c) the examples' twins", examples_phase)):
        print(f"  -- {label} (at {time.perf_counter() - t0:.1f}s)",
              flush=True)
        out[key] = fn(device)
    out["seconds"] = time.perf_counter() - t0
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
    _phase("upload transport (slice 4 main path)")
    print("  -- (a) dequant_agg: the measure_comm twin, real payloads, "
          "against its plain version", flush=True)
    transport_kernels = transport_kernel_phase()
    kernels["dequant_agg"] = transport_kernels["rows"]
    print("  -- (b) card against CPU with codecs and the async runtime",
          flush=True)
    parity["transport"] = transport_parity_phase("cuda", "cpu")
    print("  -- (c) the codec and async study", flush=True)
    transport = transport_phase("cuda")
    _phase("model zoo serving (slice 5 main path)")
    print("  -- (a) flash_attention and ssm_scan against their plain "
          "versions", flush=True)
    zoo_kernels = zoo_kernel_phase()
    kernels["flash_attention"] = zoo_kernels["flash_attention"]
    kernels["ssm_scan"] = zoo_kernels["ssm_scan"]
    print("  -- (b) card against CPU: zamba2 reduced to 4 layers", flush=True)
    parity["zoo"] = zoo_parity_phase("cuda", "cpu")
    print("  -- (c) zamba2-1.2b at full width and depth", flush=True)
    zamba = zamba2_phase("cuda")
    print("  -- (d) yi-9b at full width, 4 of its 48 layers", flush=True)
    yi = yi_phase("cuda")
    _phase("result documents (the scenario runner, schema v2.5)")
    documents = result_doc_phase("cuda")
    _phase("fused executor and serving")
    t_fused = time.perf_counter()
    print("  -- (a) fused against vectorized, eager and the CPU", flush=True)
    fused_parity = fused_parity_phase("cuda", "cpu")
    _reset_launches()                    # the main path's count starts here
    print("  -- (b) result documents of the fused registrations", flush=True)
    fused_docs = fused_document_phase("cuda")
    print("  -- (c) serving and the Chrome trace", flush=True)
    serving = serve_trace_phase("cuda")
    torch.cuda.synchronize()
    from repro_torch.core.simulation import FederatedSimulation
    fused_calls = FederatedSimulation._kernel_launches()
    # the launches the 4 fused registrations' replayed graphs made, as the
    # profiles of their build windows counted them on the device
    fused_launches = {k: sum(d["launches"][k] for d in fused_docs.values())
                      for k in fused_calls}
    print(f"  fused registrations: replayed launches {fused_launches} "
          f"(profiled); wrapper calls in 11(b)-(c) {fused_calls}",
          flush=True)
    print("  -- (d) rounds per second", flush=True)
    rates = fused_rate_phase("cuda")
    fused_s = time.perf_counter() - t_fused
    print(f"  phase 11 took {fused_s:.1f}s", flush=True)
    _phase("model zoo, rest (slice 11)")
    print("  -- (a) qwen3-moe, deepseek-v2-lite, xlstm, seamless, "
          "phi-3-vision at their published widths", flush=True)
    zoo_rest = zoo_rest_main_phase("cuda")
    print("  -- (b) card against CPU: the five reduced", flush=True)
    parity["zoo_rest"] = zoo_rest_parity_phase("cuda", "cpu")
    _phase("training (slice 12)")
    train = train_phase("cuda")
    _phase("mesh (slice 13)")
    t_mesh = time.perf_counter()
    print("  -- (a) the mesh operators on ranks sharing the card", flush=True)
    mesh_ops = mesh_operator_phase("cuda")
    mesh_run = mesh_executor_phase("cuda")
    mesh_s = time.perf_counter() - t_mesh
    print(f"  phase 14 took {mesh_s:.1f}s", flush=True)
    _phase("the zoo's sharded steps and the dry-run (slice 14)")
    sharded = sharded_phase("cuda")
    print(f"  phase 15 took {sharded['seconds']:.1f}s", flush=True)
    _phase("the examples' twins and the graphed decode (slice 15)")
    _reset_launches()                    # the main path's count starts here
    decode_graph = decode_graph_phase("cuda")
    print(f"  phase 16 took {decode_graph['seconds']:.1f}s", flush=True)
    _phase()

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
    # the 32-client median: half of the acceptance family's launches, and
    # the one with a library call (torch.quantile)
    trep = next(r for r in trows
                if (r["C"], r["N"], r["trim"]) == (32, 7900, 15))
    tentry = {
        "name": "trimmed_mean_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trimmed_mean_agg.cu",
        "replaces": "src/repro/kernels/robust_agg.py:190",
        "launches": adversarial["launches"]["trimmed_mean_agg"],
        "max_abs_err": max(r["max_abs_err"] for r in trows),
        "ms": trep["ms"], "plain_ms": trep["plain_ms"],
        "bound_ms": trep["bound_ms"], "bound_by": trep["bound_by"],
        "library_ms": trep["library_ms"], "sort_ms": trep["sort_ms"],
        "shape": [32, 7900], "trim": 15,
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
    drows = kernels["dequant_agg"]
    drep = next(r for r in drows if (r["C"], r["N"]) == (32, 7900)
                and "ms" in r)
    dentry = {
        "name": "dequant_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dequant_agg.cu",
        "replaces": "src/repro/kernels/comm_agg.py:58",
        "launches": transport_kernels["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in drows),
        "ms": drep["ms"], "plain_ms": drep["plain_ms"],
        "bound_ms": drep["bound_ms"], "bound_by": drep["bound_by"],
        "library_ms": None, "cast_gemv_ms": drep["cast_gemv_ms"],
        "bound_share": drep["bound_share"], "design": drep["design"],
        "shape": [32, 7900], "shapes": [r for r in drows if "ms" in r]}
    frows = kernels["flash_attention"]
    frep = next(r for r in frows if r["case"] == ZAMBA
                and r["dtype"] == "bfloat16")
    flentry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:104",
        "launches": zamba["launches"]["flash_attention"],
        "launches_yi": yi["launches"]["flash_attention"],
        "launches_zoo_rest": zoo_rest["launches"]["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in frows),
        "ms": frep["ms"], "plain_ms": frep["plain_ms"],
        "bound_ms": frep["bound_ms"], "bound_by": frep["bound_by"],
        "library_ms": frep["library_ms"], "shape": [2, 4096, 32, 64],
        "dtype": "bfloat16", "design": frep["design"],
        "tflops": frep["tflops"],
        "shapes": [r for r in frows if "ms" in r]}
    # the float32 kernel (3xTF32) at the same shape, its own numbers
    f32 = next(r for r in frows if r["case"] == ZAMBA
               and r["dtype"] == "float32")
    flentry["float32"] = {k: f32[k] for k in (
        "ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
        "bound_ms", "bound_by", "bound_share", "design", "tflops",
        "max_abs_err")}
    srows = kernels["ssm_scan"]
    srep = next(r for r in srows if r["case"] == ZAMBA
                and r["dtype"] == "bfloat16")
    sentry = {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:84",
        "launches": zamba["launches"]["ssm_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in srows),
        "ms": srep["ms"], "plain_ms": srep["plain_ms"],
        "bound_ms": srep["bound_ms"], "bound_by": srep["bound_by"],
        "library_ms": None, "shape": [2, 4096, 64, 64, 64],
        "dtype": "bfloat16", "shapes": [r for r in srows if "ms" in r],
        "launches_zoo_rest": zoo_rest["launches"]["ssm_scan"]}
    for e in (flentry, sentry):
        # each rank's launches in 15(c)'s sharded kernel prefill and decode
        e["launches_sharded"] = [r[e["name"]]
                                 for r in sharded["serve"]["launches"]]
    for e in (entry, tentry):
        e["launches_churn"] = churn["launches"][e["name"]]
    entry["launches_transport"] = transport["launches"]["fedavg_agg"]
    entry["launches_documents"] = documents["fedavg_agg_launches"]
    for e in (entry, tentry, gentry, dentry):
        e["launches_fused"] = fused_launches[e["name"]]
    for e in (entry, gentry):
        # each FL twin run's launches in 16(c)
        e["launches_examples"] = {
            label: run["launches"][e["name"]]
            for label, run in decode_graph["examples"].items()
            if "launches" in run}
    doc = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "build_s": build_s,
           "kernels": kernels, "parity": parity, "study": study,
           "adversarial": adversarial, "churn": churn,
           "transport_kernels": transport_kernels, "transport": transport,
           "zoo_occupancy": zoo_kernels["occupancy"],
           "zoo": {"zamba2": zamba, "yi": yi}, "zoo_rest": zoo_rest,
           "train": train,
           "mesh": {"operators": mesh_ops, "executor": mesh_run,
                    "seconds": mesh_s},
           "sharded": sharded, "decode_graph": decode_graph,
           "phase_seconds": PHASE_SECONDS,
           "documents": documents,
           "fused": {"parity": fused_parity, "documents": fused_docs,
                     "serving": serving, "launches": fused_launches,
                     "wrapper_calls": fused_calls,
                     "rates": rates, "seconds": fused_s}}
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
        "bound_share": r["bound_share"],
        "launches": entry["launches"]} for r in entry["shapes"]]
        + [{"name": "trimmed_mean_agg", "replaces": tentry["replaces"],
            "C": r["C"], "N": r["N"], "trim": r["trim"],
            "max_err": r["max_abs_err"], "kernel_us": r["ms"] * 1e3,
            "plain_us": r["plain_ms"] * 1e3, "sort_us": r["sort_ms"] * 1e3,
            "library_us": (r["library_ms"] * 1e3 if r["library_ms"]
                           else None),
            "bound_us": r["bound_ms"] * 1e3,
            "kernel_graph_us": r["graph_ms"] * 1e3,
            "plain_graph_us": r["plain_graph_ms"] * 1e3,
            "sort_graph_us": r["sort_graph_ms"] * 1e3,
            "library_graph_us": (r["library_graph_ms"] * 1e3
                                 if r["library_ms"] else None),
            "bound_share": r["bound_share"],
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
            "launches": gentry["launches"]} for r in gentry["shapes"]]
        + [{"name": "dequant_agg", "replaces": dentry["replaces"],
            "C": r["C"], "N": r["N"], "max_err": r["max_abs_err"],
            "kernel_us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
            "cast_gemv_us": r["cast_gemv_ms"] * 1e3,
            "bound_us": r["bound_ms"] * 1e3,
            "kernel_graph_us": r["graph_ms"] * 1e3,
            "plain_graph_us": r["plain_graph_ms"] * 1e3,
            "cast_gemv_graph_us": r["cast_gemv_graph_ms"] * 1e3,
            "bound_share": r["bound_share"],
            "graph_gb_per_s": r["graph_gb_per_s"], "design": r["design"],
            "launches": dentry["launches"]} for r in dentry["shapes"]]
        + [{"name": e["name"], "replaces": e["replaces"], "case": r["case"],
            "dtype": r["dtype"], "max_err": r["max_abs_err"],
            "kernel_us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
            "library_us": (r["library_ms"] * 1e3 if "library_ms" in r
                           else None),
            "bound_us": r["bound_ms"] * 1e3,
            "kernel_graph_us": r["graph_ms"] * 1e3,
            "plain_graph_us": r["plain_graph_ms"] * 1e3,
            **({"design": r["design"], "tflops": r["tflops"],
                "bound_share": r["bound_share"]}
               if "design" in r else {}),
            "launches": e["launches"]}
           for e in (flentry, sentry) for r in e["shapes"]]))
    print(card)
    print(json.dumps({"kernels": [entry, tentry, gentry, dentry, flentry,
                                  sentry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
