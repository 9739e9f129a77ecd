"""End-to-end federated training (twin of
`examples/federated_image_classification.py`): the paper's experiment as a
runnable example on the card. Train the §2.4 CNN across clients under any
REGISTERED Strategy plugin (the paper's hfl/afl/cfl, the async runtime,
fedprox, fedavgm/fedadam, or a third-party plugin — `repro_torch.api`),
report the full metric suite, and dump per-round accuracy/loss curves
(paper Figs. 9/11).

    PYTHONPATH=src python -m repro_torch.examples.federated_image_classification \
        --strategy cfl --dataset fashion --rounds 10 --clients 10 --curves

It takes the reference script's flags, with the same choices and
defaults, and prints the same lines; `--device cpu` runs it on the CPU.
Beyond-paper options: --non-iid (Dirichlet label skew), --gossip
(decentralized ring aggregation for AFL), strategy-plugin knobs
(--prox-mu, --server-lr/--server-momentum), the adversarial axis
(--attack/--attack-fraction/--attack-scale toggles Byzantine clients,
--defense/--clip-tau selects the robust aggregator — DESIGN.md §8), the
communication axis (--codec/--topk-frac/--quant-bits compresses client
uploads on the wire and reports the byte-count cost model — DESIGN.md
§12), and the scenario registry: `--list-scenarios` / `--scenario NAME`
runs a named scenario (core/scenarios.py) and prints its stable result
document. Observability (DESIGN.md §13): telemetry is on by default and
a per-phase time breakdown prints with the metrics; --trace-out PATH
writes the run's Chrome-trace JSON (open in Perfetto /
chrome://tracing), --xla-profile DIR captures a torch.profiler trace
(host and card) alongside, --no-telemetry runs without the tracer
(results are bitwise identical either way). Serving (DESIGN.md §14):
--serve attaches the federation-in-the-loop serving side-car (--qps /
--arrival shape the traffic) and prints the serving block. Churn and
faults (DESIGN.md §15): --fault-profile compiles a deterministic
crash/rejoin/dropout/straggler/flaky schedule from the run seed
(--churn-rate severity, --quorum-frac degradation threshold, --fault-mtd
re-randomizes the gossip ring every round) and prints the faults block;
"none" is structurally inert.

    PYTHONPATH=src python -m repro_torch.examples.federated_image_classification \
        --strategy afl --clients 16 --engine vectorized \
        --attack sign_flip --attack-scale 4 --defense trimmed_mean
"""
import argparse
import csv
import os


def main(argv=None):
    """Run the example; returns the run's `FLResult` (with `--scenario`,
    its result document; with `--list-scenarios`, None)."""
    from repro_torch import api
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", choices=api.strategy_names(),
                    default="cfl",
                    help="any registered Strategy plugin (repro_torch.api)")
    ap.add_argument("--dataset", choices=["mnist", "fashion"],
                    default="mnist")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--participation", type=float, default=0.5)
    ap.add_argument("--merge-alpha", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--n-train", type=int, default=3000)
    ap.add_argument("--gossip", action="store_true")
    ap.add_argument("--non-iid", action="store_true",
                    help="Dirichlet(0.5) label-skew partition (paper §4 "
                         "future work, implemented here)")
    ap.add_argument("--prox-mu", type=float, default=0.01,
                    help="fedprox: proximal term weight mu")
    ap.add_argument("--server-lr", type=float, default=1.0,
                    help="fedavgm/fedadam: server optimizer step size")
    ap.add_argument("--server-momentum", type=float, default=0.9,
                    help="fedavgm: server momentum")
    ap.add_argument("--outdir", default=None,
                    help="output root for curves/results (default: the "
                         "shared convention, experiments/ or "
                         "$REPRO_OUTPUT_DIR)")
    from repro_torch.core.fl_types import ATTACKS, DEFENSES
    ap.add_argument("--attack", choices=ATTACKS, default="none",
                    help="Byzantine client attack (core/attacks.py): a "
                         "rng-chosen subset corrupts its uploads between "
                         "training and aggregation (label_flip poisons "
                         "the shard instead)")
    ap.add_argument("--attack-fraction", type=float, default=0.25,
                    help="fraction of clients that are Byzantine")
    ap.add_argument("--attack-scale", type=float, default=1.0,
                    help="attack magnitude (flip/boost factor or sigma)")
    ap.add_argument("--defense", choices=DEFENSES, default="none",
                    help="robust aggregation rule (core/robust.py); "
                         "validity depends on the strategy's aggregation "
                         "event (DESIGN.md §8)")
    ap.add_argument("--clip-tau", type=float, default=10.0,
                    help="norm_clip: max L2 of an accepted update delta")
    ap.add_argument("--codec", choices=api.codec_names(), default="none",
                    help="upload codec: compress client uploads on the "
                         "wire (core/codecs.py; DESIGN.md §12) — topk "
                         "sparsification with error feedback, qsgd "
                         "stochastic quantization, or a registered "
                         "third-party codec")
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="topk: fraction of coordinates shipped per round")
    ap.add_argument("--quant-bits", type=int, choices=[8, 16], default=8,
                    help="qsgd: 8 = int8 + per-client scale (~4x), "
                         "16 = stochastic bfloat16 (2x)")
    from repro_torch.core.fl_types import ARRIVALS
    ap.add_argument("--serve", action="store_true",
                    help="federation-in-the-loop serving (DESIGN.md "
                         "§14): an open-loop traffic trace is "
                         "micro-batched against the global model on a "
                         "virtual clock, with a round-boundary hot-swap "
                         "after every aggregation event; prints the "
                         "serving block (p50/p95/p99, shed rate, "
                         "staleness). Training results are bitwise "
                         "identical with or without it")
    ap.add_argument("--qps", type=float, default=64.0,
                    help="serving: mean offered load, requests/s of "
                         "virtual time")
    ap.add_argument("--arrival", choices=ARRIVALS, default="poisson",
                    help="serving: arrival process shape (same mean "
                         "load; burst/diurnal redistribute it)")
    from repro_torch.core.faults import FAULT_PROFILES
    ap.add_argument("--fault-profile", choices=FAULT_PROFILES,
                    default="none",
                    help="churn/fault injection (DESIGN.md §15): compile "
                         "a deterministic per-round fault schedule from "
                         "the run seed — crash/rejoin churn, transient "
                         "dropout, straggler slowdown, flaky links, or "
                         "the mid-severity mix. 'none' is structurally "
                         "inert (bitwise-identical run)")
    ap.add_argument("--churn-rate", type=float, default=0.3,
                    help="fault profile severity: target dead fraction "
                         "(churn/dropout) or loss rate (flaky)")
    ap.add_argument("--quorum-frac", type=float, default=0.5,
                    help="min alive fraction for an aggregation event "
                         "to commit; below it the event degrades (hold "
                         "the model / skip the tick, DESIGN.md §15)")
    ap.add_argument("--fault-mtd", action="store_true",
                    help="moving-target defense: re-randomize the "
                         "gossip ring every round so a colluding "
                         "neighborhood cannot pin its victims")
    ap.add_argument("--curves", action="store_true",
                    help="write per-round curves CSV (paper Figs. 9/11)")
    ap.add_argument("--engine", choices=["loop", "vectorized", "fused"],
                    default="loop",
                    help="loop = paper-faithful per-client dispatch; "
                         "vectorized = the whole federation stacked, with "
                         "kernel-backed aggregation (same results, "
                         "scales to hundreds of clients); fused = one "
                         "round captured as a CUDA graph and replayed, "
                         "state on the card end to end (same results "
                         "again — sync strategies only, DESIGN.md §10)")
    ap.add_argument("--scenario", metavar="NAME",
                    help="run a named registry scenario instead of the "
                         "flag-built config (core/scenarios.py)")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="print the scenario registry and exit")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write the run's Chrome-trace JSON (DESIGN.md "
                         "§13; open in Perfetto / chrome://tracing)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable the host tracer (results are bitwise "
                         "identical either way)")
    ap.add_argument("--xla-profile", metavar="DIR",
                    help="capture a torch.profiler trace of the run into "
                         "DIR (Perfetto / chrome://tracing; the card's "
                         "kernels beneath the host ops)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.no_telemetry and args.trace_out:
        ap.error("--trace-out needs telemetry (drop --no-telemetry)")

    if args.list_scenarios:
        from repro_torch.core import scenarios
        scenarios.main(["--list"])
        return None
    dev = resolve_device(args.device)
    if args.scenario:
        import json
        from repro_torch.core import scenarios
        from repro_torch.obs import profiler_trace
        with profiler_trace(args.xla_profile):
            res = scenarios.run_scenario(args.scenario, device=dev,
                                         trace_out=args.trace_out)
        _print_phase_table(res.get("telemetry"))
        print(json.dumps(res, indent=1))
        if args.trace_out:
            print(f"trace -> {args.trace_out}")
        return res

    ds = DATASETS[args.dataset](n_train=args.n_train,
                                n_test=max(500, args.n_train // 5))
    fl = api.FLConfig(strategy=args.strategy, num_clients=args.clients,
                      num_groups=args.groups, rounds=args.rounds,
                      local_epochs=args.local_epochs,
                      participation=args.participation,
                      merge_alpha=args.merge_alpha, lr=args.lr,
                      afl_mode="gossip" if args.gossip else "fedavg",
                      prox_mu=args.prox_mu, server_lr=args.server_lr,
                      server_momentum=args.server_momentum,
                      attack=args.attack,
                      attack_fraction=args.attack_fraction,
                      attack_scale=args.attack_scale, defense=args.defense,
                      clip_tau=args.clip_tau, codec=args.codec,
                      topk_frac=args.topk_frac, quant_bits=args.quant_bits,
                      telemetry=not args.no_telemetry,
                      engine=args.engine, serve=args.serve,
                      serve_qps=args.qps, serve_arrival=args.arrival,
                      fault_profile=args.fault_profile,
                      churn_rate=args.churn_rate,
                      quorum_frac=args.quorum_frac,
                      fault_mtd=args.fault_mtd)
    sim = api.FederatedSimulation(fl, ds, device=dev)
    if args.non_iid:
        from repro_torch.data.partition import dirichlet_partition
        _, ytr = ds["train"]
        sim.set_partition(dirichlet_partition(ytr, args.clients, alpha=0.5))

    from repro_torch.obs import profiler_trace, write_chrome_trace
    with profiler_trace(args.xla_profile):
        r = sim.run()
    if args.trace_out:
        write_chrome_trace(sim.telemetry, args.trace_out)
    print(f"\n=== {args.strategy.upper()} on {ds['name']} "
          f"({'non-IID' if args.non_iid else 'IID'}) ===")
    if args.attack != "none" or args.defense != "none":
        print(f"attack:             {args.attack} "
              f"(clients {[int(c) for c in sim.attackers]}, "
              f"scale {args.attack_scale})")
        print(f"defense:            {args.defense}")
    print(f"training acc:       {r.train_accuracy:.3f}")
    print(f"testing acc:        {r.test_accuracy:.3f}")
    print(f"precision/recall:   {r.precision:.3f} / {r.recall:.3f}")
    print(f"F1 / balanced acc:  {r.f1:.3f} / {r.balanced_accuracy:.3f}")
    print(f"build time:         {r.build_time_s:.2f}s "
          f"(+ {r.warmup_time_s:.2f}s warmup)")
    print(f"classification:     {r.classification_time_s:.4f}s")
    _print_phase_table(r.extra.get("telemetry"))
    comm = r.extra.get("communication")
    if comm:
        print(f"codec:              {comm['codec']} "
              f"(uplink {comm['uplink_bytes']:,} B, "
              f"dense {comm['dense_uplink_bytes']:,} B, "
              f"{comm['compression_ratio']:.2f}x compression)")
    srv = r.extra.get("serving")
    if srv:
        lm = srv["latency_ms"]
        acc = srv["served_accuracy"]
        print(f"serving:            {srv['arrival']} "
              f"{srv['qps_target']:.0f} qps target -> "
              f"{srv['completed']}/{srv['requests']} served "
              f"({srv['shed_rate']:.1%} shed), "
              f"{srv['swap_count']} hot-swaps")
        print(f"  latency (virtual) p50 {lm['p50']:.1f}ms / "
              f"p95 {lm['p95']:.1f}ms / p99 {lm['p99']:.1f}ms; "
              f"occupancy {srv['batch_occupancy']:.2f}; "
              f"staleness mean {srv['staleness']['mean']:.2f} "
              f"max {srv['staleness']['max']}"
              + (f"; served acc {acc:.3f}" if acc is not None else ""))
    flt = r.extra.get("faults")
    if flt:
        print(f"faults:             {flt['profile']} "
              f"(rate {flt['churn_rate']:.2f}, "
              f"mtd {'on' if flt['mtd'] else 'off'}): "
              f"mean alive {flt['mean_alive_frac']:.2f}, "
              f"{flt['rejoins']} rejoins, "
              f"{flt['quorum_failures']} quorum failures, "
              f"{flt['degraded_rounds']} degraded rounds")
    print("confusion matrix:")
    for row in r.confusion:
        print("   " + " ".join(f"{v:4d}" for v in row))

    if args.curves:
        # one output-dir convention for every curve/result writer
        name = f"curves_{args.strategy}_{args.dataset}.csv"
        if args.outdir:
            path = os.path.join(args.outdir, "curves", name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
        else:
            path = api.output_path("curves", name)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["round", "train_acc", "train_loss", "test_acc"])
            for i, (ta, tl, te) in enumerate(zip(
                    r.round_train_acc, r.round_train_loss, r.round_test_acc)):
                w.writerow([i, ta, tl, te])
        print(f"curves -> {path}")
    if args.trace_out:
        print(f"trace -> {args.trace_out}")
    return r


def _print_phase_table(tel):
    """The per-phase time breakdown from the result document's
    telemetry block (DESIGN.md §13): steady-state lifecycle phases
    first, then the fused executor's per-phase device-time proxy when
    the run produced one."""
    if not tel or not tel.get("enabled"):
        return
    proxy = tel.get("fused_phase_proxy") or {}
    # drop the proxy's container spans — only the lifecycle phases
    # nested inside them belong in the breakdown
    proxy = {k: v for k, v in proxy.items()
             if k not in ("fused_phase_proxy", "round")}
    for title, block in (("phase breakdown (host dispatch):",
                          tel.get("phases")),
                         ("fused per-phase proxy (device time, 1 round):",
                          proxy)):
        if not block:
            continue
        total = sum(e["total_s"] for e in block.values()) or 1.0
        print(title)
        for name, e in sorted(block.items(),
                              key=lambda kv: -kv[1]["total_s"]):
            print(f"   {name:18s} {e['total_s']:8.3f}s "
                  f"x{e['count']:<4d} ({100 * e['total_s'] / total:5.1f}%)")


if __name__ == "__main__":
    main()
