"""One step captured as a CUDA graph: the warm-up and capture shared by
the graphed serve step (`launch.serve.make_graphed_serve_step`) and the
graphed train step (`launch.train.make_graphed_train_step`), the port's
forms of the reference's `jax.jit` of those steps.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def capture(body, state, what: str, pool=None, warmup: int = 2):
    """(graph, out): `body(state)` captured as one `torch.cuda.CUDAGraph`,
    `out` being what the captured call returned (the graph's static
    outputs, rewritten by each replay).

    `body(st)` writes its results into `st`, a tree (dicts and lists) of
    CUDA tensors, in place. It is first run `warmup` times (at least
    once) on a side stream on a throwaway clone of `state` (first-use
    costs: autograd's and the libraries' workspaces, the allocator's
    growth; a caller whose process already ran the body eagerly has paid
    most of them), then captured once on `state`; capturing runs
    nothing, so `state` is as it was given.
    `pool` (another graph's `pool()`) shares that graph's memory pool. A
    capture that fails raises RuntimeError naming `what`: there is no
    eager fallback."""
    dev = tree_leaves(state)[0].device
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        scratch = tree_map(torch.clone, state)
        for _ in range(max(1, warmup)):
            body(scratch)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    del scratch
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = body(state)
    except Exception as e:
        raise RuntimeError(
            f"{what} could not be captured as a CUDA graph "
            f"({type(e).__name__}: {e}); it does not fall back to eager "
            f"steps") from e
    return graph, out
