"""The paper's aggregation strategies over the model zoo (port of
`repro.core.trainer`).

Every parameter carries a leading `num_clients` dim. Local training runs
K optimizer steps on each client's micro-batches; an aggregation event is
then an array op over the client dim, as in the reference:

    HFL  reshape (groups, per_group) + two-tier weighted mean
    AFL  masked weighted mean, or gossip: the +-1 roll ring
    CFL  weighted mean + EMA merge into the continual global model

each accumulated in float32 in a plain einsum (the reference's XLA
einsum; no aggregation kernel runs here). `fl_train_step` is one round:
K local steps per client, then one aggregation event.

With `mesh=None` one device holds every client and the local phase loops
over them. With `mesh` a `launch.mesh.RankMesh` the trainer runs in each
rank of a mesh, as the reference's SPMD program runs on each device:
the client dim lies over "data" (and "pod") as `fit_spec` lays it, so a
rank holds C / size(client axes) consecutive clients, and each client's
leaves are sharded over "model" by `fl_param_spec`
(`fl_tree_shardings(_opt)`, `state_shardings`). A rank runs the K local
steps of each of its clients on the client's shards: under the tp
profile, where "model" is tensor-parallel within a client (the
reference's FL mesh), each rank computes its "model" shard of each layer
(`models.parallel`), gathering a layer's leaves when it runs; elsewhere
the layers are computed whole, their leaves gathered a layer at a time.
It joins
the aggregation event through the mesh operators of `core/aggregation.py`
(`mesh_hfl`, `mesh_afl_fedavg`, `mesh_cfl`) with the weighted mean of its
clients, HFL groups that straddle ranks through their sums by group
(`mesh_hfl_by_group`), or gossip's ring of clients across ranks
(`mesh_afl_gossip`'s ring with several clients a rank: the rank's end
clients as counted collective-permutes); it keeps its shards of the
result. Where C does not divide over the client axes, every rank holds every
client, as GSPMD replicates the dim, and aggregates them itself.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.fl_types import FLConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import value_and_grad
from repro_torch.optim import optimizers
from repro_torch.sharding import specs as sh
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# FL sharding: the client axis in front, only "model" within a client
# ---------------------------------------------------------------------------

def fl_client_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fl_param_spec(path: str, shape, mesh) -> sh.PartitionSpec:
    """Spec of a client-stacked leaf (C, *base_shape); a stacked layer
    leaf is (C, L, *per_layer), both leading dims skipped for the
    per-layer rules. The client dim takes the client axes; the other dims
    keep only "model"."""
    shape = tuple(shape)
    if sh._STACKED_RE.search(path) and len(shape) >= 3:
        base = sh.P(None, *sh.spec_for_param(path, shape[2:], mesh))
    else:
        base = sh.spec_for_param(path, shape[1:], mesh)
    cleaned = ["model" if e == "model" else None for e in base]
    ca = fl_client_axes(mesh)
    return sh.fit_spec(shape, sh.P(ca if len(ca) > 1 else ca[0], *cleaned),
                       mesh)


def fl_tree_shardings(client_params, mesh):
    return tree_map(lambda pair: sh.NamedSharding(
        mesh, fl_param_spec(pair[0], pair[1].shape, mesh)),
        sh._paths(client_params))


def fl_tree_shardings_opt(opt_state, mesh):
    """Optimizer state mirrors the parameters' sharding; leaves of at most
    one dim are replicated."""
    def one(pair):
        path, leaf = pair
        if leaf.ndim <= 1:
            return sh.NamedSharding(mesh, sh.P())
        return sh.NamedSharding(mesh, fl_param_spec(path, leaf.shape, mesh))
    return tree_map(one, sh._paths(opt_state))


def _ring_mix(stacked, axis):
    """Gossip over the ring of all clients, this rank's (C_local, ...)
    clients consecutive on it: each client averages with its +-1
    neighbours; the rank's end clients meet the neighbouring ranks' through
    one `ppermute` of both ends (two collective-permutes)."""
    from repro_torch.core.collectives import ppermute
    from repro_torch.kernels import ops as kops
    mat = kops.stacked_ravel(stacked)
    ends = mat[:1] if len(mat) == 1 else mat[[0, -1]]
    before, after = ppermute(ends, axis, (1, -1))
    left = torch.cat([before[-1][None], mat[:-1]])
    right = torch.cat([mat[1:], after[0][None]])
    return kops.stacked_unravel(stacked, (mat + left + right) / 3.0)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _client(tree, c):
    return tree_map(lambda x: x[c], tree)


class FederatedTrainer:
    """`fl_train_step` for (model, FLConfig) on one device (`mesh=None`)
    or in one rank of a `launch.mesh.RankMesh`."""

    def __init__(self, model, fl: FLConfig, mesh=None,
                 optimizer: Optional[optimizers.Optimizer] = None):
        self.model = model
        self.fl = fl
        self.mesh = mesh
        self.opt = optimizer or optimizers.sgd(fl.lr, momentum=fl.momentum)
        if mesh is not None:
            C = fl.num_clients
            ca = fl_client_axes(mesh.shape)
            ca = sh.entry_axes(sh.fit_spec(
                (C,), sh.P(ca if len(ca) > 1 else ca[0]), mesh.shape)[0])
            # the client axes the client dim lies over (none: replicated)
            self._clients = mesh.axis(ca) if ca else None
            n = self._clients.size if ca else 1
            self._local = C // n
            self._first = (self._clients.index if ca else 0) * self._local
            self._shardings = None
            self._parallel = None

    # -- state ---------------------------------------------------------------

    def init_state(self, generator=None, *, client_params=None,
                   global_params=None, device="cuda") -> Dict[str, Any]:
        """Client params stacked on a leading (C,) dim, the clients' stacked
        optimizer states and the round counter; CFL adds the global model.
        The params are drawn from `generator` (a CPU torch.Generator: C
        client inits, then CFL's global init) unless given: `client_params`
        stacked, `global_params` for CFL (e.g. the reference's init through
        `convert.params_from_jax`)."""
        dev = resolve_device(device)
        if self.mesh is not None:
            return self._init_shards(generator, client_params,
                                     global_params, dev)
        C = self.fl.num_clients
        if client_params is None:
            client_params = _stack([self.model.init(generator, dev)
                                    for _ in range(C)])
        client_params = tree_map(lambda x: x.to(dev), client_params)
        state = {"client_params": client_params,
                 "opt": _stack([self.opt.init(_client(client_params, c))
                                for c in range(C)]),
                 "round": torch.zeros((), dtype=torch.int64, device=dev)}
        if self.fl.strategy == "cfl":
            if global_params is None:
                global_params = self.model.init(generator, dev)
            state["global_params"] = tree_map(lambda x: x.to(dev),
                                              global_params)
        return state

    # -- the mesh ------------------------------------------------------------

    def state_shardings(self, state):
        """The shardings of a (global) state tree on the mesh."""
        mesh = self.mesh.shape
        out = {"client_params": fl_tree_shardings(state["client_params"],
                                                  mesh),
               "opt": fl_tree_shardings_opt(state["opt"], mesh),
               "round": sh.NamedSharding(mesh, sh.P())}
        if "global_params" in state:
            out["global_params"] = sh.tree_shardings(state["global_params"],
                                                     mesh)
        return out

    def state_specs(self) -> Dict[str, Any]:
        """The global state tree on the meta device (the reference's
        `jax.eval_shape(trainer.init_state, key)`)."""
        p = self.model.param_specs()
        C = self.fl.num_clients
        state = {"client_params": _stack([p] * C),
                 "opt": _stack([self.opt.init(p)] * C),
                 "round": torch.zeros((), dtype=torch.int64, device="meta")}
        if self.fl.strategy == "cfl":
            state["global_params"] = p
        return state

    def _mesh_shardings(self):
        if self._shardings is None:
            self._shardings = self.state_shardings(self.state_specs())
        return self._shardings

    def _view(self):
        """The rank's `models.parallel.Parallel` for one client's local
        steps: its leaves stored as its client's slice of the stacked
        shards, no batch axis (a client's rows are its own)."""
        if self._parallel is None:
            from repro_torch.models.parallel import Parallel
            mesh = self.mesh.shape
            client = tree_map(lambda s: sh.NamedSharding(
                mesh, sh.P(*s.spec[1:])),
                self._mesh_shardings()["client_params"])
            self._parallel = Parallel(self.model.cfg, self.mesh, client,
                                      self.model.param_specs())
        return self._parallel

    def shard_state(self, state):
        """This rank's shards of a global state."""
        from repro_torch.launch.mesh import shard_tree
        return shard_tree(state, self._mesh_shardings(), self.mesh)

    @property
    def local_clients(self) -> range:
        """The clients this rank holds (all of them off a mesh)."""
        if self.mesh is None:
            return range(self.fl.num_clients)
        return range(self._first, self._first + self._local)

    def _init_shards(self, generator, client_params, global_params, dev):
        """`init_state` on a rank: the C client inits are drawn in order
        (each on the CPU, one at a time) and only this rank's clients are
        kept, so no rank holds the stacked state; then its shards."""
        from repro_torch.launch.mesh import shard_tree
        shardings = self._mesh_shardings()
        mine = self.local_clients
        if client_params is None:
            local = []
            for c in range(self.fl.num_clients):
                p = self.model.init(generator, "cpu")
                if c in mine:
                    local.append(tree_map(lambda x: x.to(dev), p))
            local = _stack(local)
        else:
            local = tree_map(lambda x: x[mine.start:mine.stop].to(dev),
                             client_params)
        opt = _stack([self.opt.init(_client(local, i))
                      for i in range(len(mine))])
        state = {"client_params": self._to_shards(
                     local, shardings["client_params"]),
                 "opt": self._to_shards(opt, shardings["opt"]),
                 "round": torch.zeros((), dtype=torch.int64, device=dev)}
        if self.fl.strategy == "cfl":
            if global_params is None:
                global_params = self.model.init(generator, dev)
            state["global_params"] = shard_tree(
                tree_map(lambda x: x.to(dev), global_params),
                shardings["global_params"], self.mesh)
        return state

    def _client_view(self, tree, shardings, keep=()):
        """This rank's clients' leaves, stacked (C_local, ...): gathered
        over "model" but the axes in `keep`; a replicated client-stacked
        leaf gives its rows."""
        from repro_torch.launch.mesh import gather
        ca = fl_client_axes(self.mesh.shape)
        mine = self.local_clients

        def one(x, s):
            x = gather(x, s, self.mesh, keep=ca + tuple(keep))
            if len(s.spec) and s.spec[0] is not None:
                return x
            return x[mine.start:mine.stop]
        return tree_map(one, tree, shardings)

    def _to_shards(self, tree, shardings, keep=()):
        """This rank's clients' leaves (C_local, ...), whole but over the
        axes in `keep` -> the rank's shards of the global (C, ...) leaves;
        a leaf whose client dim is replicated is gathered over the clients
        first."""
        from repro_torch.launch.mesh import all_gather, cut_from
        ca = fl_client_axes(self.mesh.shape)

        def one(x, s):
            lead = len(s.spec) and s.spec[0] is not None
            if not lead and self._clients is not None:
                x = all_gather(x, self._clients, dim=0)
            return cut_from(x, s, self.mesh,
                            tuple(keep) + (ca if lead else ()))
        return tree_map(one, tree, shardings)

    def _mesh_aggregate(self, stacked, weights, participate, glob):
        """The aggregation event over the client axes for this rank's
        stacked clients -> (stacked clients, CFL's new global). The mesh
        operators take the rank's clients as their weighted mean (float32)
        and its weight, which they weigh as they weigh one client (HFL's
        groups hold whole ranks, or a rank whole groups: tier 1 then runs
        in the rank); HFL groups that straddle ranks sum by group in one
        all_reduce (`mesh_hfl_by_group`); gossip runs the ring of clients
        across ranks."""
        from repro_torch.core import aggregation as agg
        fl, axis = self.fl, self._clients

        def broadcast(out):
            return tree_map(lambda m, x: m.to(x.dtype)[None].expand(
                x.shape).contiguous(), out, stacked)

        if fl.strategy == "afl" and fl.afl_mode == "gossip":
            return _ring_mix(stacked, axis), None
        per, local = fl.num_clients // fl.num_groups, len(self.local_clients)
        if fl.strategy == "hfl" and per % local and local % per:
            return broadcast(agg.mesh_hfl_by_group(
                stacked, weights, fl.num_groups, self._first,
                axis=axis)), None
        w = participate.float() * weights if fl.strategy == "afl" else weights
        tot = w.sum()
        wn = w / torch.where(tot > 0, tot, torch.ones_like(tot))
        mean = tree_map(lambda x: torch.einsum("c,c...->...", wn, x.float()),
                        stacked)
        if fl.strategy == "cfl":
            _, glob = agg.mesh_cfl(mean, glob, tot, fl.merge_alpha,
                                   client_axis=axis)
            a = fl.merge_alpha
            return tree_map(lambda c, g: ((1 - a) * c.float()
                                          + a * g.float()[None]).to(c.dtype),
                            stacked, glob), glob
        if fl.strategy == "hfl" and local <= per:
            out = agg.mesh_hfl(mean, tot, client_axis=axis,
                               num_groups=fl.num_groups)
        else:
            # AFL's masked mean; HFL with whole groups in the rank
            out = agg.mesh_afl_fedavg(mean, tot, 1.0, client_axis=axis)
        return broadcast(out), None

    def _mesh_step(self, state, batch, weights, participate):
        from repro_torch.core.collectives import all_reduce_sum
        from repro_torch.launch.mesh import cut_from, gather_tree
        from repro_torch.models import parallel
        fl, axis = self.fl, self._clients
        shardings = self._mesh_shardings()
        mine = self.local_clients
        view = self._view()
        # the clients' shards as stored over "model", each client's local
        # steps on them (its layers cut over "model" under tp)
        keep = ("model",) if "model" in self.mesh.names else ()
        params = self._client_view(state["client_params"],
                                   shardings["client_params"], keep)
        opt_state = self._client_view(state["opt"], shardings["opt"], keep)
        with parallel.use(view):
            outs = [self._local_steps(_client(params, i),
                                      _client(opt_state, i),
                                      _client(batch, i))
                    for i in range(len(mine))]
        params = _stack([o[0] for o in outs])
        opt_state = _stack([o[1] for o in outs])
        loss = torch.stack([o[2] for o in outs]).float().sum()
        glob = None
        if fl.strategy == "cfl":
            g_sh = shardings["global_params"]
            # kept over "model" where the clients' leaves are
            gkeep = tree_map(lambda s: keep if set(keep) & set(s.axes())
                             else (), shardings["client_params"])
            glob = gather_tree(state["global_params"], g_sh, self.mesh,
                               keep=gkeep)
        if axis is None:
            params, glob = self._aggregate(params, weights, participate,
                                           glob)
        else:
            params, glob = self._mesh_aggregate(
                params, weights[mine.start:mine.stop].float(),
                participate[mine.start:mine.stop], glob)
            loss = all_reduce_sum(loss.reshape(1), axis)[0]
        new_state = dict(state)
        new_state["client_params"] = self._to_shards(
            params, shardings["client_params"], keep)
        new_state["opt"] = self._to_shards(opt_state, shardings["opt"], keep)
        new_state["round"] = state["round"] + 1
        if glob is not None:
            new_state["global_params"] = tree_map(
                lambda x, s, k: cut_from(x, s, self.mesh, k), glob, g_sh,
                gkeep)
        return new_state, {"loss": loss / fl.num_clients}

    # -- local phase ---------------------------------------------------------

    def _local_steps(self, params, opt_state, client_batch):
        """K local optimizer steps on one client's micro-batches
        (client_batch leaves: (K, B_local, ...)) -> (params, opt_state,
        mean loss)."""
        losses = []
        for k in range(next(iter(client_batch.values())).shape[0]):
            (loss, _), grads = value_and_grad(self.model.loss, params,
                                              _client(client_batch, k))
            updates, opt_state = self.opt.update(grads, opt_state, params)
            params = optimizers.apply_updates(params, updates)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean()

    # -- aggregation events (client-dim array ops) ---------------------------

    def _aggregate(self, client_params, weights, participate, global_params):
        fl = self.fl
        C = fl.num_clients
        w = weights.float()

        def wmean(p, wv):
            wn = (wv / wv.sum()).float()
            return tree_map(lambda x: torch.einsum(
                "c,c...->...", wn, x.float()).to(x.dtype), p)

        def broadcast(p):
            return tree_map(lambda x: x[None].expand((C,) + tuple(x.shape))
                            .contiguous(), p)

        if fl.strategy == "hfl":
            G = fl.num_groups
            per = C // G
            wg = w.reshape(G, per)

            def tier(x):
                xg = x.float().reshape((G, per) + tuple(x.shape[1:]))
                # tier 1: the group servers' weighted means
                wn = wg / wg.sum(dim=1, keepdim=True)
                gmodel = torch.einsum("gc,gc...->g...", wn, xg)
                # tier 2: the global server over the group models
                gw = wg.sum(dim=1) / wg.sum()
                glob = torch.einsum("g,g...->...", gw, gmodel)
                return glob[None].expand((C,) + tuple(x.shape[1:])).to(
                    x.dtype).contiguous()
            return tree_map(tier, client_params), global_params

        if fl.strategy == "afl":
            if fl.afl_mode == "gossip":
                def mix(x):
                    x32 = x.float()
                    out = (x32 + torch.roll(x32, 1, dims=0)
                           + torch.roll(x32, -1, dims=0)) / 3.0
                    return out.to(x.dtype)
                return tree_map(mix, client_params), global_params
            m = participate.float() * w
            return broadcast(wmean(client_params, m)), global_params

        # cfl: continual EMA merge
        a = fl.merge_alpha
        mean = wmean(client_params, w)
        new_global = tree_map(
            lambda g, m_: ((1 - a) * g.float() + a * m_.float()).to(g.dtype),
            global_params, mean)
        new_clients = tree_map(
            lambda c, g: ((1 - a) * c.float() + a * g.float()[None]).to(
                c.dtype), client_params, new_global)
        return new_clients, new_global

    # -- the step ------------------------------------------------------------

    def fl_train_step(self, state, batch, weights, participate):
        """One federated round. batch leaves: (C, K, B_local, ...) per-client
        micro-batches; weights: (C,) sample counts; participate: (C,) bool
        (AFL). Returns (new state, {"loss": mean of the clients' mean
        local losses}). On a mesh, `state` and `batch` are the rank's
        shards (its clients' (C_local, ...) rows) and the new state is
        too; `weights` and `participate` are whole."""
        if self.mesh is not None:
            return self._mesh_step(state, batch, weights, participate)
        C = self.fl.num_clients
        outs = [self._local_steps(_client(state["client_params"], c),
                                  _client(state["opt"], c),
                                  _client(batch, c)) for c in range(C)]
        params = _stack([o[0] for o in outs])
        opt_state = _stack([o[1] for o in outs])
        losses = torch.stack([o[2] for o in outs])
        params, new_global = self._aggregate(
            params, weights, participate, state.get("global_params"))
        new_state = dict(state)
        new_state["client_params"] = params
        new_state["opt"] = opt_state
        new_state["round"] = state["round"] + 1
        if new_global is not None and "global_params" in state:
            new_state["global_params"] = new_global
        return new_state, {"loss": losses.mean()}

    # -- batch specs for the dry-run -----------------------------------------

    def fl_batch_specs(self, seq_len, per_client_batch):
        """`model.train_batch_specs` with the (C, K) dims in front, on the
        meta device."""
        C, K = self.fl.num_clients, self.fl.local_steps
        base = self.model.train_batch_specs(per_client_batch, seq_len)
        return {k: torch.empty((C, K) + tuple(s.shape), dtype=s.dtype,
                               device=s.device) for k, s in base.items()}

    def served_model(self, state):
        """The consensus model for evaluation and serving: the mean of the
        client models, or CFL's continual global model (whole, on every
        rank of a mesh)."""
        if self.mesh is not None:
            from repro_torch.core.collectives import all_reduce_sum
            from repro_torch.launch.mesh import gather_tree
            shardings = self._mesh_shardings()
            if self.fl.strategy == "cfl":
                return gather_tree(state["global_params"],
                                   shardings["global_params"], self.mesh)
            mine = self._client_view(state["client_params"],
                                     shardings["client_params"])

            def mean(x):
                tot = x.float().sum(0)
                if self._clients is not None:
                    tot = all_reduce_sum(tot, self._clients)
                return (tot / self.fl.num_clients).to(x.dtype)
            return tree_map(mean, mine)
        if self.fl.strategy == "cfl":
            return state["global_params"]
        return tree_map(lambda x: x.float().mean(0).to(x.dtype),
                        state["client_params"])
