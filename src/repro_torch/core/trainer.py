"""The paper's aggregation strategies over the model zoo (port of
`repro.core.trainer.FederatedTrainer`, without the mesh).

Every parameter carries a leading `num_clients` dim. Local training runs
K optimizer steps on each client's micro-batches; an aggregation event is
then an array op over the client dim, as in the reference:

    HFL  reshape (groups, per_group) + two-tier weighted mean
    AFL  masked weighted mean, or gossip: the +-1 roll ring
    CFL  weighted mean + EMA merge into the continual global model

each accumulated in float32 in a plain einsum (the reference's XLA
einsum; no aggregation kernel runs here). `fl_train_step` is one round:
K local steps per client, then one aggregation event.

The reference lays the client dim over a device mesh; here one device
holds every client and the local phase loops over them. `mesh` other than
None raises: the sharded trainer (`fl_param_spec`, `fl_tree_shardings`,
`state_shardings`) is ROADMAP §A.16b, the zoo's half of A.16 (the FL
half, the mesh-sharded fused executor, is `FLConfig.mesh_devices`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.fl_types import FLConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import value_and_grad
from repro_torch.optim import optimizers
from repro_torch.tree import tree_map


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _client(tree, c):
    return tree_map(lambda x: x[c], tree)


class FederatedTrainer:
    """`fl_train_step` for (model, FLConfig) on one device."""

    def __init__(self, model, fl: FLConfig, mesh=None,
                 optimizer: Optional[optimizers.Optimizer] = None):
        if mesh is not None:
            raise NotImplementedError(
                "FederatedTrainer(mesh=...) is not ported yet: ROADMAP "
                "§A.16b (the zoo's half of A.16) brings the sharded trainer "
                "to repro_torch; pass mesh=None to train every client on "
                "one device")
        self.model = model
        self.fl = fl
        self.opt = optimizer or optimizers.sgd(fl.lr, momentum=fl.momentum)

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
        local losses})."""
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
        client models, or CFL's continual global model."""
        if self.fl.strategy == "cfl":
            return state["global_params"]
        return tree_map(lambda x: x.float().mean(0).to(x.dtype),
                        state["client_params"])
