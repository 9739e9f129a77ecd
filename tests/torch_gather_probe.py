"""What one all-gather costs on rank processes sharing the card: the
port's two gathers beside the forms they could take. Not
collected by pytest (no `test_` prefix); needs a CUDA card for the
pinned form (on the CPU that form is skipped).

    PYTHONPATH=src python3 tests/torch_gather_probe.py [cuda|cpu] [RANKS]

Each of RANKS ranks (8 by default, as chip_smoke.py's phase 15) holds a
float32 block of 1/RANKS of the result and gathers it over the whole
world, in these forms, all in one world, 5 repeats each after a warm-up,
each repeat between two barriers:

* `sum`: each rank writes its block into its slot of a result-sized
  buffer and one gloo `all_reduce` fills every slot;
* `host_join`: gloo's `all_gather` of host copies, joined on the host,
  then one copy to the card;
* `card_join`: the same, each block copied to the card and joined there;
* `pinned` (the card only): the blocks received in pinned host memory,
  then as `card_join`;
* `port`: `core.collectives.all_gather` as it stands (gloo, pinned);
* `async8` (the card only): the result cut in 8 gathers, all in flight
  at once;
* `card` (the card only): `core.collectives.card_gather`, which the
  sharded steps' `gather_tree` uses: no host, each rank opens the
  others' blocks by CUDA IPC and copies them on the card.

Then the reduction a sharded train step makes of a gradient of the
result's size (each rank keeps its 1/RANKS block of the sum):
`reduce_sum` (one gloo `all_reduce`, the port's) and `reduce_scatter`
(the card only: gloo's `reduce_scatter` of pinned host copies).

Every form must return the same bits. One line `GATHER {json}` per
result size gives the slowest rank's median milliseconds of each form.
"""
import json
import statistics
import sys
import time

SIZES = (4 << 20, 32 << 20, 256 << 20)      # result bytes
REPEATS = 5


def task(rank, sizes=SIZES, repeats=REPEATS):
    import torch
    import torch.distributed as dist

    from repro_torch.core.collectives import card_gather
    from repro_torch.launch.mesh import MeshShape, all_gather

    dev = rank.device
    cuda = dev.type == "cuda"
    n = rank.size
    axis = rank.mesh(MeshShape((n,), ("data",))).axis("data")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out = {}
    for nbytes in sizes:
        x = torch.randn(max(1, nbytes // 4 // n), device=dev)

        def received(pin):
            b = x.cpu()
            parts = [torch.empty(b.shape, dtype=b.dtype, pin_memory=pin)
                     for _ in range(n)]
            dist.all_gather(parts, b)
            return parts

        forms = {
            "sum": lambda: _sum(x, rank.rank, n),
            "host_join": lambda: torch.cat(received(False)).to(dev),
            "card_join": lambda: torch.cat([p.to(dev)
                                            for p in received(False)]),
            "port": lambda: all_gather(x, axis),
        }
        if cuda:
            forms["pinned"] = lambda: torch.cat([p.to(dev)
                                                 for p in received(True)])
            forms["async8"] = lambda: _async_pieces(x, n, dev)
            forms["card"] = lambda: card_gather([(
                x, (n * x.numel(),),
                [(j, (slice(j * x.numel(), (j + 1) * x.numel()),))
                 for j in range(n)], [n * x.numel() * 4])])[0]
        want = None
        for name, fn in forms.items():
            got = fn()
            sync()
            want = got if want is None else want
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} gathered other bits")
        # the reduction a sharded train step makes of each gradient: the
        # sum over the ranks of which this rank keeps its block
        g = torch.randn(max(n, nbytes // 4) // n * n, device=dev)
        forms["reduce_sum"] = lambda: _reduce_sum(g, rank.rank, n)
        if cuda:
            forms["reduce_scatter"] = lambda: _reduce_scatter(g, rank.rank,
                                                              n, dev)
            a, b = forms["reduce_sum"](), forms["reduce_scatter"]()
            sync()
            out.setdefault("reduce_max_abs_diff", {})[nbytes] = float(
                (a - b).abs().max())
        times = {name: [] for name in forms}
        for _ in range(repeats):
            for name, fn in forms.items():
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                sync()
                times[name].append(time.perf_counter() - t0)
        out[nbytes] = {k: statistics.median(v) * 1e3
                       for k, v in times.items()}
    return out


def _async_pieces(x, n, dev, pieces=8):
    """The gather of `x` cut in `pieces` leaves, every gather issued
    before the first is waited on (blocks in pinned memory)."""
    import torch
    import torch.distributed as dist
    works, outs = [], []
    for piece in x.chunk(pieces):
        b = piece.cpu()
        parts = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                 for _ in range(n)]
        works.append(dist.all_gather(parts, b, async_op=True))
        outs.append(parts)
    for w in works:
        w.wait()
    # rank-major: every rank's pieces in order, as one gather of x
    return torch.cat([outs[k][r].to(dev) for r in range(n)
                      for k in range(len(outs))])


def _reduce_sum(g, r, n):
    import torch.distributed as dist
    t = g.clone()
    dist.all_reduce(t)
    return t.chunk(n)[r].clone()


def _reduce_scatter(g, r, n, dev):
    import torch
    import torch.distributed as dist
    b = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
    b.copy_(g)
    mine = torch.empty(g.numel() // n, dtype=g.dtype, pin_memory=True)
    dist.reduce_scatter(mine, list(b.chunk(n)))
    return mine.to(dev)


def _sum(x, r, n):
    import torch.distributed as dist
    slots = x.new_zeros((n,) + tuple(x.shape))
    slots[r] = x
    dist.all_reduce(slots)
    return slots.reshape(-1)


def main(argv):
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_gather_probe
    from repro_torch.launch import mesh

    device = argv[0] if argv else "cuda"
    ranks = int(argv[1]) if len(argv) > 1 else 8
    t0 = time.perf_counter()
    with mesh.World(ranks, device=device, timeout=300) as world:
        res = world.run(torch_gather_probe.task)
    card = None
    if device == "cuda":
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    for nbytes in SIZES:
        slowest = {k: max(r[nbytes][k] for r in res) for k in res[0][nbytes]}
        diff = res[0].get("reduce_max_abs_diff", {}).get(nbytes)
        print("GATHER " + json.dumps({
            "device": device, "card": card, "ranks": ranks,
            "result_bytes": nbytes, "slowest_rank_ms": slowest,
            "reduce_max_abs_diff": diff}), flush=True)
    print(f"probe took {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
