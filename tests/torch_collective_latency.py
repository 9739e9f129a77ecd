"""What one collective costs on rank processes sharing the card, from the
KB of a sharded decode step's activations to the MB of a layer's
weights: where the host path of `core.collectives` (`SMALL_GATHER_BYTES`)
stops paying. Not collected by pytest (no `test_` prefix).

    PYTHONPATH=src python3 tests/torch_collective_latency.py [cuda|cpu] [RANKS]

Each of RANKS ranks (8 by default, as chip_smoke.py's phase 15) runs,
after a warm-up, each form below on a float32 block of each size in
BLOCKS, timing each call to its end (a synchronize on the card):

* `sum_gloo`: gloo's own all_reduce of the card's tensor;
* `sum_host`: a host copy, a gloo all_gather, the sum on the host and one
  copy back (`collectives._sum`'s host path);
* `gather_card_join`: a gloo all_gather into pinned host blocks, each
  copied to the card and joined there (`collectives.all_gather` above
  SMALL_GATHER_BYTES);
* `gather_host_join`: the blocks joined on the host and copied once
  (`all_gather` at most SMALL_GATHER_BYTES);
* `card_gather`: the port's card-to-card gather (the card only);
* `barrier`: a gloo barrier, the floor of any of them.

One line `LATENCY {json}` gives, for each size (the result's bytes: the
block's times RANKS), the slowest rank's median milliseconds of each
form, with the card's name and power limit.
"""
import json
import statistics
import sys
import time

# elements of a rank's float32 block: results of 16 KB to 16 MB at 8 ranks
BLOCKS = (512, 4096, 16384, 32768, 131072, 524288)


def task(rank):
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.launch.mesh import MeshShape

    dev = rank.device
    cuda = dev.type == "cuda"
    n = rank.size
    rank.mesh(MeshShape((n,), ("data",)))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def forms(x):
        numel = x.numel()

        def sum_gloo():
            dist.all_reduce(x.clone())

        def sum_host():
            h = x.cpu()
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h)
            for p in parts[1:]:
                parts[0] += p
            return parts[0].to(dev)

        def gather(pinned):
            h = x.cpu()
            parts = [torch.empty(h.shape, dtype=h.dtype, pin_memory=pinned)
                     for _ in range(n)]
            dist.all_gather(parts, h)
            if pinned:
                return torch.cat([p.to(dev) for p in parts])
            return torch.cat(parts).to(dev)

        out = {"sum_gloo": sum_gloo, "sum_host": sum_host,
               "gather_card_join": lambda: gather(cuda),
               "gather_host_join": lambda: gather(False),
               "barrier": lambda: dist.barrier()}
        if cuda:
            whole = (numel * n,)
            out["card_gather"] = lambda: collectives.card_gather([
                (x, whole, [(j, (slice(j * numel, (j + 1) * numel),))
                            for j in range(n)], [])])
        return out

    res = {}
    for numel in BLOCKS:
        x = torch.full((numel,), float(rank.rank), device=dev)
        calls = 40 if numel * n * 4 <= 1 << 20 else 20
        row = {}
        for name, fn in forms(x).items():
            fn()
            sync()
            times = []
            for _ in range(calls):
                t0 = time.perf_counter()
                fn()
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            row[name] = statistics.median(times)
        res[numel * n * 4] = row
    return res


def main():
    import subprocess

    from repro_torch.launch import mesh
    device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    ranks = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    card = None
    if device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    with mesh.World(ranks, device=device, timeout=600) as w:
        outs = w.run(task)
    print("LATENCY " + json.dumps({
        "device": device, "card": card, "ranks": ranks,
        "ms_by_result_bytes": {
            size: {k: max(o[size][k] for o in outs) for k in outs[0][size]}
            for size in outs[0]}}))


if __name__ == "__main__":
    main()
