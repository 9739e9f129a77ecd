"""Readings of the port against the JAX reference on the CPU, beyond what
the tests assert: distances per event and whole learning curves, printed
and written as JSON. Not collected by pytest (no `test_` prefix).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_reference_probe.py \
        hfl4 [--out FILE]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_reference_probe.py \
        acc32 [--out FILE]

hfl4  — HFL, 4 clients in 2 groups, Gaussian attack (scale 0.5) against
        the trimmed mean, 2 rounds, chip_smoke.py's data (the configuration
        whose card-vs-CPU parity broke 1e-3 under the vectorized engine).
        Per event, the max |a - b| over the round model's leaves between
        every two of {reference, port} x {loop, vectorized}, both packages
        starting from the reference's initial model and then from the
        port's, with the reference's Gaussian noise (as in the tests); and
        the port's two engines with its own noise (as on the card). Then
        the reference's own sensitivity: its round model after a one-ulp
        change of one initial weight.
acc32 — the 32-client sign-flip acceptance family
        (`attack-{none,signflip-fedavg,signflip-median,signflip-trimmed}-32c-vec`)
        through both packages from the reference's initial parameters:
        per-round test accuracy and the final macro-F1 of each.
churn32 — the 32-client churn acceptance pair
        (`churn-signflip-median-{mtd,static}`) through both packages from
        the reference's initial parameters, and through the port from its
        own: per-round test accuracy, macro-F1, the `faults` block and
        the MTD margin (mtd F1 - static F1) of each.
comm32 — the codec acceptance pair (`comm-qsgd-accept-32c-vec` against
        its dense twin `comm-dense-accept-32c-vec`): the reference from its
        own init; the port from the reference's init (with its own rounding
        uniforms, as on the card, and with the reference's); the port from
        its own init. Per run the per-round test accuracy and macro-F1; per
        pair |dF1| (qsgd - dense); per port run the largest per-round
        test-accuracy gap to the reference's run from the same init.
async — the async family (`async-{uniform,straggler,dropout}-vec`,
        `async-lognormal-loop`, `attack-gauss-async-clip-vec`) and
        `comm-topk-async-loop` through both packages from the reference's
        initial parameters (the reference's Gaussian noise): test accuracy,
        macro-F1 and the timeline block of each.
chunk — the port alone: the fused AFL star of the reference's mesh-parity
        test (tests/test_mesh_fused.py: 16 clients, 3 rounds, n_train
        1024) on one device, trained in stacks of 1, 2 and 4 clients
        (`fused_chunk`) at 1 and 8 intra-op threads, against the unchunked
        run at 1 thread: the largest gap in each metric the reference's
        mesh test gates (ROADMAP §C.4: a 1-client stack is a plain
        convolution, whose bits on the CPU depend on the thread count).
twin32 — the clean twin of `churn-signflip-median-mtd` (attack and
        defense off; chip_smoke.py's `churn-clean-mtd`, the run that mixes
        through `gossip_mix_agg`) through the port on the CPU from its own
        init, under the vectorized and the loop engine: per-round test
        accuracy and training loss.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_reference_probe.py \
        churn32 [--out FILE]
    PYTHONPATH=src python tests/torch_reference_probe.py twin32 [--out FILE]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_reference_probe.py \
        comm32 [--out FILE]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_reference_probe.py \
        async [--out FILE]
    PYTHONPATH=src python tests/torch_reference_probe.py chunk [--out FILE]
"""
import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import attacks as ref_attacks  # noqa: E402
from repro.core import codecs as ref_codecs  # noqa: E402
from repro.core import fl_types as ref_types  # noqa: E402
from repro.core import scenarios as ref_scenarios  # noqa: E402
from repro.core import simulation as ref_sim_mod  # noqa: E402
from repro.data.synthetic import mnist_like  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import attacks as port_attacks  # noqa: E402
from repro_torch.core import codecs as port_codecs  # noqa: E402
from repro_torch.core import fl_types as port_types  # noqa: E402
from repro_torch.core import scenarios as port_scenarios  # noqa: E402
from repro_torch.core import simulation as port_sim_mod  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def ref_gauss_noise(seed, event, client_id, leaf_index, shape, device):
    key = jax.random.fold_in(jax.random.fold_in(
        ref_attacks.event_key(seed, event), client_id), leaf_index)
    return torch.as_tensor(np.array(jax.random.normal(
        key, tuple(shape), jnp.float32))).to(device)


def _ref_leaves(model):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(model)]


def _port_leaves(model):
    return [x.double().numpy() for x in tree_leaves(model)]


def _dist(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _pair(ds, fl_kw, init="reference"):
    """(reference sim, port sim) from one config and one initial model:
    the reference's draw, or with `init="port"` the port's."""
    if init == "port":
        port = port_sim_mod.FederatedSimulation(
            port_types.FLConfig(**fl_kw), ds, device="cpu")
        start = convert.params_to_numpy(port.init_params)
        ref = ref_sim_mod.FederatedSimulation(
            ref_types.FLConfig(**fl_kw), ds,
            model_init=lambda key: jax.tree.map(jnp.asarray, start))
        return ref, port
    ref = ref_sim_mod.FederatedSimulation(ref_types.FLConfig(**fl_kw), ds)
    start = jax.tree.map(np.asarray, ref.init_params)
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**fl_kw), ds,
        model_init=lambda g: convert.params_from_jax(start), device="cpu")
    return ref, port


HFL4 = dict(num_clients=4, num_groups=2, rounds=2, local_batch_size=32,
            lr=0.03, momentum=0.9, seed=0, participation=1.0,
            strategy="hfl", attack="gauss", attack_scale=0.5,
            defense="trimmed_mean")


def _hfl4_models(ds, ref_noise, init):
    """Round-model leaves after each event, keyed (package, engine, event),
    both packages from the initial model `init` draws; with `ref_noise`
    the port draws the reference's Gaussian noise, else its own
    (`attacks.gauss_noise`, as on the card)."""
    seam = port_attacks.gauss_noise
    if ref_noise:
        port_attacks.gauss_noise = ref_gauss_noise
    try:
        models = {}
        for engine in ("loop", "vectorized"):
            ref, port = _pair(ds, dict(HFL4, engine=engine), init)
            rs = ref.strategy.init_state(ref)
            ps = port.strategy.init_state(port)
            for ev in range(HFL4["rounds"]):
                rs, _, _ = ref.strategy.run_event(ref, rs, ev)
                ps, _, _ = port.strategy.run_event(port, ps, ev)
                models[("ref", engine, ev)] = _ref_leaves(
                    ref.strategy.round_model(rs))
                models[("port", engine, ev)] = _port_leaves(
                    port.strategy.round_model(ps))
        return models
    finally:
        port_attacks.gauss_noise = seam


def probe_hfl4():
    ds = mnist_like(seed=0, n_train=512, n_test=128)   # chip_smoke.py's
    runs = [(p, e) for p in ("ref", "port") for e in ("loop", "vectorized")]
    out = {}
    for init, noise in (("reference", "reference"), ("port", "reference"),
                        ("port", "port")):
        models = _hfl4_models(ds, noise == "reference", init)
        pairs = ([(a, b) for i, a in enumerate(runs) for b in runs[i + 1:]]
                 if noise == "reference" else [(runs[2], runs[3])])
        for a, b in pairs:
            label = (f"{' '.join(a)} vs {' '.join(b)}, {init}'s init, "
                     f"{noise}'s noise")
            out[label] = [_dist(models[a + (ev,)], models[b + (ev,)])
                          for ev in range(HFL4["rounds"])]
            print(f"{label}: max |a - b| per event {out[label]}",
                  flush=True)
    nudged = _hfl4_nudges(ds)
    return {"config": HFL4, "max_abs_diff_per_event": out,
            "reference_nudged_init": nudged}


def _hfl4_nudges(ds, per_leaf=3):
    """The reference's own sensitivity: from the port's initial model with
    one weight moved by one ulp (`per_leaf` seeded picks per leaf), each
    engine's round model after the last event against the un-nudged
    reference loop run."""
    port = port_sim_mod.FederatedSimulation(
        port_types.FLConfig(**dict(HFL4, engine="loop")), ds, device="cpu")
    start = convert.params_to_numpy(port.init_params)

    def run(engine, nudge=None):
        params = jax.tree.map(np.array, start)
        if nudge is not None:
            (layer, leaf), i = nudge
            flat = params[layer][leaf].reshape(-1)
            flat[i] = np.nextafter(flat[i], np.float32(np.inf))
        ref = ref_sim_mod.FederatedSimulation(
            ref_types.FLConfig(**dict(HFL4, engine=engine)), ds,
            model_init=lambda key: jax.tree.map(jnp.asarray, params))
        rs = ref.strategy.init_state(ref)
        for ev in range(HFL4["rounds"]):
            rs, _, _ = ref.strategy.run_event(ref, rs, ev)
        return _ref_leaves(ref.strategy.round_model(rs))

    rng = np.random.default_rng(0)
    base = run("loop")
    out = []
    for layer in start:
        for leaf in start[layer]:
            for _ in range(per_leaf):
                i = int(rng.integers(start[layer][leaf].size))
                for engine in ("loop", "vectorized"):
                    d = _dist(base, run(engine, ((layer, leaf), i)))
                    out.append({"leaf": f"{layer}.{leaf}", "index": i,
                                "engine": engine, "max_abs_diff": d})
    far = [r for r in out if r["max_abs_diff"] > 1e-4]
    print(f"reference from the port's init, one weight nudged by one ulp: "
          f"{len(far)} of {len(out)} runs land > 1e-4 from the un-nudged "
          f"loop run ({sorted({r['max_abs_diff'] for r in far})}); the "
          f"rest within {max(r['max_abs_diff'] for r in out if r not in far)}",
          flush=True)
    return out


def probe_acc32():
    out = {}
    for name in port_scenarios.ACCEPTANCE_FAMILY:
        spec = port_scenarios.get(name)
        ref_spec = ref_scenarios.get(name)
        ds = port_scenarios.DATASETS[spec.dataset](
            seed=spec.seed, n_train=spec.n_train, n_test=spec.n_test)
        t0 = time.perf_counter()
        ref = ref_sim_mod.FederatedSimulation(ref_spec.to_fl_config(), ds)
        start = jax.tree.map(np.asarray, ref.init_params)
        port = port_sim_mod.FederatedSimulation(
            spec.to_fl_config(), ds,
            model_init=lambda g: convert.params_from_jax(start),
            device="cpu")
        rr, pr = ref.run(), port.run()
        out[name] = {
            "ref_round_test_acc": [float(v) for v in rr.round_test_acc],
            "port_round_test_acc": [float(v) for v in pr.round_test_acc],
            "ref_f1": float(rr.f1), "port_f1": float(pr.f1),
            "ref_test_accuracy": float(rr.test_accuracy),
            "port_test_accuracy": float(pr.test_accuracy)}
        print(f"{name} ({time.perf_counter() - t0:.0f}s)\n"
              f"  ref  f1={rr.f1:.4f} test acc per round "
              f"{np.round(rr.round_test_acc, 4).tolist()}\n"
              f"  port f1={pr.f1:.4f} test acc per round "
              f"{np.round(pr.round_test_acc, 4).tolist()}", flush=True)
    for who in ("ref", "port"):
        base = out["attack-none-32c-vec"][f"{who}_f1"]
        ratios = {n: out[n][f"{who}_f1"] / base
                  for n in port_scenarios.ACCEPTANCE_FAMILY}
        out[f"{who}_f1_over_no_attack"] = ratios
        print(f"{who} macro-F1 over no attack: "
              + ", ".join(f"{n}={v:.3f}" for n, v in ratios.items()))
    return out


CHURN_PAIR = ("churn-signflip-median-mtd", "churn-signflip-median-static")


def probe_churn32():
    out = {}
    for name in CHURN_PAIR:
        spec = port_scenarios.get(name)
        ds = port_scenarios.DATASETS[spec.dataset](
            seed=spec.seed, n_train=spec.n_train, n_test=spec.n_test)
        t0 = time.perf_counter()
        ref = ref_sim_mod.FederatedSimulation(
            ref_scenarios.get(name).to_fl_config(), ds)
        start = jax.tree.map(np.asarray, ref.init_params)
        runs = {"ref": ref, "port": port_sim_mod.FederatedSimulation(
                    spec.to_fl_config(), ds,
                    model_init=lambda g: convert.params_from_jax(start),
                    device="cpu"),
                "port_own_init": port_sim_mod.FederatedSimulation(
                    spec.to_fl_config(), ds, device="cpu")}
        out[name] = {}
        for who, sim in runs.items():
            r = sim.run()
            out[name][who] = {
                "round_test_acc": [float(v) for v in r.round_test_acc],
                "f1": float(r.f1), "test_accuracy": float(r.test_accuracy),
                "faults": r.extra["faults"]}
            print(f"{name} {who}: f1={r.f1:.4f} test acc per round "
                  f"{np.round(r.round_test_acc, 4).tolist()}", flush=True)
        print(f"  ({time.perf_counter() - t0:.0f}s)", flush=True)
    for who in ("ref", "port", "port_own_init"):
        margin = (out[CHURN_PAIR[0]][who]["f1"]
                  - out[CHURN_PAIR[1]][who]["f1"])
        out[f"{who}_mtd_margin"] = margin
        print(f"{who}: MTD margin (mtd F1 - static F1) {margin:+.4f}")
    return out


def probe_twin32():
    spec = dataclasses.replace(port_scenarios.get(CHURN_PAIR[0]),
                               name="churn-clean-mtd", attack="none",
                               defense="none")
    out = {}
    for engine in ("vectorized", "loop"):
        r = port_scenarios.run(dataclasses.replace(spec, engine=engine),
                               device="cpu")
        out[engine] = {"round_test_acc": [float(v) for v in r.round_test_acc],
                       "round_train_loss": [float(v) for v in
                                            r.round_train_loss],
                       "f1": float(r.f1)}
        print(f"{engine}: f1={r.f1:.4f}\n  test acc per round "
              f"{np.round(r.round_test_acc, 4).tolist()}\n  train loss per "
              f"round {np.round(r.round_train_loss, 3).tolist()}", flush=True)
    return out


COMM_PAIR = port_scenarios.COMM_ACCEPTANCE_PAIR


def ref_uniforms(seed, event, client_id, n, device):
    key = ref_codecs.upload_keys(seed, event, jnp.asarray([client_id]))[0]
    return torch.as_tensor(np.array(jax.random.uniform(key, (n,)))).to(
        device)


def probe_comm32():
    spec = port_scenarios.get(COMM_PAIR[0])
    ds = port_scenarios.DATASETS[spec.dataset](
        seed=spec.seed, n_train=spec.n_train, n_test=spec.n_test)
    own_uniforms = port_codecs.rounding_uniforms
    out = {}
    for name in COMM_PAIR:
        fl_kw = dataclasses.asdict(port_scenarios.get(name).to_fl_config())
        t0 = time.perf_counter()
        ref, port = _pair(ds, fl_kw)
        _, port_ref_draws = _pair(ds, fl_kw)
        _, port_own = _pair(ds, fl_kw, init="port")
        runs = {"ref": ref, "port": port,
                "port_ref_uniforms": port_ref_draws,
                "port_own_init": port_own}
        if name == COMM_PAIR[1]:        # dense: no uniforms to swap
            del runs["port_ref_uniforms"]
        out[name] = {}
        for who, sim in runs.items():
            port_codecs.rounding_uniforms = (
                ref_uniforms if who == "port_ref_uniforms" else own_uniforms)
            r = sim.run()
            port_codecs.rounding_uniforms = own_uniforms
            out[name][who] = {
                "round_test_acc": [float(v) for v in r.round_test_acc],
                "f1": float(r.f1), "test_accuracy": float(r.test_accuracy),
                "communication": r.extra.get("communication")}
            print(f"{name} {who}: f1={r.f1:.4f} test acc per round "
                  f"{np.round(r.round_test_acc, 4).tolist()}", flush=True)
        print(f"  ({time.perf_counter() - t0:.0f}s)", flush=True)
    for who in ("ref", "port", "port_own_init"):
        delta = (out[COMM_PAIR[0]][who]["f1"]
                 - out[COMM_PAIR[1]][who]["f1"])
        out[f"{who}_delta_f1"] = delta
        print(f"{who}: |dF1| (qsgd - dense) {abs(delta):.4f} "
              f"({delta:+.4f})")
    for name in COMM_PAIR:
        ref_acc = np.asarray(out[name]["ref"]["round_test_acc"])
        for who in ("port", "port_ref_uniforms"):
            if who in out[name]:
                gap = np.abs(np.asarray(out[name][who]["round_test_acc"])
                             - ref_acc)
                out[name][f"{who}_max_round_gap"] = float(gap.max())
                print(f"{name} {who} vs ref: per-round test-accuracy gap "
                      f"{np.round(gap, 4).tolist()}")
    return out


ASYNC_FAMILY = port_scenarios.ASYNC_SCENARIOS + ("comm-topk-async-loop",)


def probe_async():
    port_attacks.gauss_noise = ref_gauss_noise
    out = {}
    for name in ASYNC_FAMILY:
        spec = port_scenarios.get(name)
        ds = port_scenarios.DATASETS[spec.dataset](
            seed=spec.seed, n_train=spec.n_train, n_test=spec.n_test)
        ref, port = _pair(ds, dataclasses.asdict(spec.to_fl_config()))
        rr, pr = ref.run(), port.run()
        keys = ("merges", "batches", "mean_staleness", "makespan",
                "dropped_clients", "participants")
        out[name] = {
            who: {"f1": float(r.f1), "test_accuracy": float(r.test_accuracy),
                  "train_accuracy": float(r.train_accuracy),
                  **{k: r.extra[k] for k in keys}}
            for who, r in (("ref", rr), ("port", pr))}
        same = all(rr.extra[k] == pr.extra[k] for k in keys)
        print(f"{name}: ref f1={rr.f1:.4f} acc={rr.test_accuracy:.4f}; "
              f"port f1={pr.f1:.4f} acc={pr.test_accuracy:.4f}; "
              f"timeline block equal: {same}", flush=True)
    return out


def probe_chunk():
    ds = mnist_like(seed=0, n_train=1024, n_test=256)
    cfg = dict(strategy="afl", num_clients=16, rounds=3, num_groups=8,
               local_epochs=1, local_batch_size=16, lr=0.05, seed=0,
               participation=1.0, engine="fused")
    keys = ("round_train_acc", "round_train_loss", "round_test_acc",
            "test_accuracy", "train_accuracy", "f1")

    def run(threads, chunk):
        torch.set_num_threads(threads)
        return port_sim_mod.FederatedSimulation(
            port_types.FLConfig(**dict(cfg, fused_chunk=chunk)), ds,
            device="cpu").run()

    base = run(1, 0)
    out = {}
    for threads in (1, 8):
        for chunk in (0, 1, 2, 4):
            if (threads, chunk) == (1, 0):
                continue
            r = run(threads, chunk)
            gaps = {k: float(np.max(np.abs(
                np.asarray(getattr(r, k), np.float64)
                - np.asarray(getattr(base, k), np.float64)))) for k in keys}
            out[f"threads{threads}-chunk{chunk}"] = gaps
            print(f"threads {threads}, fused_chunk {chunk} vs the unchunked "
                  f"run at 1 thread: {gaps}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("hfl4", "acc32", "churn32", "twin32",
                                      "comm32", "async", "chunk"))
    ap.add_argument("--out", help="write the readings here as JSON")
    args = ap.parse_args()
    torch.set_num_threads(2)
    doc = {"hfl4": probe_hfl4, "acc32": probe_acc32,
           "churn32": probe_churn32, "twin32": probe_twin32,
           "comm32": probe_comm32, "async": probe_async,
           "chunk": probe_chunk}[args.probe]()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)


if __name__ == "__main__":
    main()
