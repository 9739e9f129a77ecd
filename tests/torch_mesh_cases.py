"""Rank-side halves of the port's mesh tests (`test_torch_mesh.py`,
`test_torch_mesh_fused.py`) and of chip_smoke.py's phase 14: functions a
`launch.mesh.World` calls on every rank. Each takes the full inputs as
numpy arrays, slices its rank's shard, runs one mesh operator and returns
its output as numpy with the rank's collective counts. Imports torch and
the port only, so the ranks never load jax."""
import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.launch import mesh
from repro_torch.sharding.specs import MeshShape


def _shard(rank, a):
    n = a.shape[0] // rank.size
    return a[rank.rank * n:(rank.rank + 1) * n]


def _t(rank, a):
    return torch.as_tensor(np.asarray(a), device=rank.device)


def _out(tree):
    return {k: v.cpu().numpy() for k, v in tree.items()}


def stacked_op(rank, op, stacked, weights, **kw):
    """One mesh-sharded STACKED operator on the rank's client shard of
    `stacked` (C, N) and `weights` (C,). Returns (output, counts)."""
    axis = rank.axis()
    local = {"w": _t(rank, _shard(rank, stacked))}
    w = _t(rank, _shard(rank, weights))
    mesh.reset_collective_counts()
    if op == "fedavg":
        out = agg.mesh_fedavg_stacked(local, w, axis=axis)
    elif op == "hfl":
        out = agg.mesh_hfl_stacked(local, w, kw["groups"], axis=axis,
                                   force_fallback=kw["fallback"])
    elif op == "gossip":
        out = agg.mesh_gossip_stacked(local, _t(rank, kw["mix"]), axis=axis)
    elif op == "tier1":
        with mesh.collective_scope("tier1"):
            groups, gw = agg.hfl_tier1_local(local, w, kw["groups_local"])
        with mesh.collective_scope("tier2"):
            agg.mesh_fedavg_stacked(groups, gw, axis=axis)
        out = dict(groups, gw=gw)
    else:
        raise ValueError(op)
    return _out(out), mesh.collective_counts()


def model_op(rank, op, stacked, weights, **kw):
    """One mesh-level operator with ONE client a rank: client r holds row
    r of `stacked` with weight `weights[r]`."""
    params = {"w": _t(rank, stacked[rank.rank])}
    w = _t(rank, weights[rank.rank])
    mesh.reset_collective_counts()
    if kw.get("pod"):
        m = rank.mesh(MeshShape(kw["pod"], ("pod", "data")))
        client, pod = m.axis("data"), m.axis("pod")
    else:
        client, pod = rank.axis(), None
    if op == "hfl":
        out = agg.mesh_hfl(params, w, client_axis=client,
                           num_groups=kw.get("groups", 2), pod_axis=pod,
                           force_fallback=kw.get("fallback", False))
    elif op == "afl_fedavg":
        out = agg.mesh_afl_fedavg(
            params, w, _t(rank, kw["participate"][rank.rank]),
            client_axis=client, pod_axis=pod)
    elif op == "afl_gossip":
        out = agg.mesh_afl_gossip(params, client_axis=client,
                                  steps=kw.get("steps", 1))
    elif op == "cfl":
        new_client, new_global = agg.mesh_cfl(
            params, {"w": _t(rank, kw["global"])}, w, kw["alpha"],
            client_axis=client, pod_axis=pod)
        out = {"w": new_client["w"], "global": new_global["w"]}
    else:
        raise ValueError(op)
    return _out(out), mesh.collective_counts()


def fail_on(rank, bad_rank):
    """Rank `bad_rank` raises; the others wait in an all_reduce it never
    joins."""
    if rank.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    mesh.all_reduce_sum(torch.ones(2, device=rank.device))
    return rank.rank


def packed_gather(rank, fulls, names):
    """`collectives.packed_gather` of the rank's block (its index on the
    axis over `names` of a (data 2, model 2) mesh) of each (array, dim) of
    `fulls`, beside `all_gather` of each block. Returns (packed results,
    all_gather results, the packed call's counts)."""
    from repro_torch.core import collectives
    axis = rank.mesh(MeshShape((2, 2), ("data", "model"))).axis(names)
    items = []
    for full, d in fulls:
        n = full.shape[d] // axis.size
        items.append((_t(rank, np.take(full, range(axis.index * n,
                                                   (axis.index + 1) * n),
                                       axis=d)), d))
    want = [collectives.all_gather(x, axis, d) for x, d in items]
    mesh.reset_collective_counts()
    got = collectives.packed_gather(items, axis)
    return ([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want],
            mesh.collective_counts())
