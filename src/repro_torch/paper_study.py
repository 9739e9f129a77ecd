"""The paper study on the port: Tables 1-2 and the headline claims C1-C4
(the twin of `benchmarks/paper_tables.py`).

Runs HFL vs AFL vs CFL with the §2.4 CNN on the MNIST-like and
Fashion-MNIST-like datasets and emits the paper's measurement suite:
training/testing accuracy, build time, classification time (Table 1) and
precision/recall/F1/accuracy (Table 2).

Experiment design (DESIGN.md §2), as in the reference:
  * IID partition, identical CNN everywhere, equal round budgets.
  * HFL: 2 groups; 2 local epochs/round; global tier every 2 rounds.
  * AFL: 50% participation, 2 local epochs, FedAvg among participants.
  * CFL: sequential client pass, continual merge alpha=0.5.

    python -m repro_torch.paper_study --scale quick [--engine vectorized]

runs on the card ("cuda"); `--device cpu` runs on the CPU. Times printed
are the run's own, on the device it names.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.fl_types import FLConfig
from repro_torch.core.simulation import FederatedSimulation
from repro_torch.data.synthetic import fashion_like, mnist_like

SCALES = {
    # n_train, n_test, clients, rounds, local_batch
    "full": (2000, 500, 8, 8, 32),
    "quick": (2000, 500, 8, 8, 32),
    "smoke": (400, 150, 4, 2, 32),
}
DATASETS = {"mnist": mnist_like, "fashion": fashion_like}


def make_fl(strategy, clients, rounds, batch, seed=0, engine="loop"):
    common = dict(num_clients=clients, num_groups=2, rounds=rounds,
                  local_batch_size=batch, lr=0.03, momentum=0.9, seed=seed,
                  engine=engine)
    if strategy == "hfl":
        return FLConfig(strategy="hfl", local_epochs=2, **common)
    if strategy == "afl":
        return FLConfig(strategy="afl", local_epochs=2, participation=0.5,
                        **common)
    return FLConfig(strategy="cfl", local_epochs=1, merge_alpha=0.5, **common)


def run_study(scale="quick", seed=0, verbose=True, *, device="cuda",
              engine="loop", datasets=("mnist", "fashion")):
    """One FLResult per (dataset, strategy), datasets in the given order
    and hfl, afl, cfl within each."""
    n_train, n_test, clients, rounds, batch = SCALES[scale]
    results = []
    for name in datasets:
        ds = DATASETS[name](seed=seed, n_train=n_train, n_test=n_test)
        for strategy in ("hfl", "afl", "cfl"):
            fl = make_fl(strategy, clients, rounds, batch, seed, engine)
            t0 = time.perf_counter()
            r = FederatedSimulation(fl, ds, device=device).run()
            if verbose:
                print(f"  {ds['name']:13s} {strategy}: "
                      f"train={r.train_accuracy:.2f} "
                      f"test={r.test_accuracy:.2f} "
                      f"build={r.build_time_s:.3f}s "
                      f"class={r.classification_time_s:.4f}s "
                      f"f1={r.f1:.2f} "
                      f"launches={r.extra['kernel_launches']['fedavg_agg']} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
            results.append(r)
    return results


def table1(results):
    """Paper Table 1: accuracy & time per environment x dataset."""
    return [(r.dataset, r.strategy.upper(), r.train_accuracy,
             r.test_accuracy, r.build_time_s, r.classification_time_s)
            for r in results]


def table2(results):
    """Paper Table 2: precision/recall/F1/accuracy."""
    return [(r.dataset, r.strategy.upper(), r.precision, r.recall, r.f1,
             r.test_accuracy) for r in results]


def claims_check(results):
    """The paper's headline claims C1-C4 (DESIGN.md §1)."""
    by = {(r.dataset, r.strategy): r for r in results}
    checks = {}
    for ds in sorted(set(r.dataset for r in results)):
        h, a, c = by[(ds, "hfl")], by[(ds, "afl")], by[(ds, "cfl")]
        # strict ordering, or all three saturated (>=0.97)
        checks[f"C1 {ds}: CFL>AFL>HFL test acc"] = (
            (c.test_accuracy > a.test_accuracy > h.test_accuracy)
            or min(c.test_accuracy, a.test_accuracy,
                   h.test_accuracy) >= 0.97)
        checks[f"C2 {ds}: AFL shortest build"] = (
            a.build_time_s < h.build_time_s
            and a.build_time_s < c.build_time_s)
        checks[f"C3 {ds}: CFL shortest classification"] = (
            c.classification_time_s <= a.classification_time_s
            and c.classification_time_s <= h.classification_time_s)
        checks[f"C4 {ds}: HFL largest generalization gap"] = (
            (h.train_accuracy - h.test_accuracy)
            >= max(a.train_accuracy - a.test_accuracy,
                   c.train_accuracy - c.test_accuracy) - 0.01)
    return checks


def print_tables(results):
    def fmt(row):
        return ", ".join(repr(x) if isinstance(x, float) else str(x)
                         for x in row)
    print("Table 1 (dataset, env, train_acc, test_acc, build_s, class_s):")
    for row in table1(results):
        print("  " + fmt(row))
    print("Table 2 (dataset, env, precision, recall, f1, accuracy):")
    for row in table2(results):
        print("  " + fmt(row))
    print("Claims:")
    for k, v in claims_check(results).items():
        print(f"  [{'PASS' if v else 'FAIL'}] {k}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="quick", choices=sorted(SCALES))
    ap.add_argument("--engine", default="loop",
                    choices=("loop", "vectorized"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(f"paper study on repro_torch: scale={args.scale} "
          f"engine={args.engine} device={args.device}")
    results = run_study(args.scale, args.seed, device=args.device,
                        engine=args.engine)
    print_tables(results)


if __name__ == "__main__":
    main()
