"""Serving: prefill, single-token decode steps and the token-model
dispatch for the serving engine (port of `repro.launch.serve`, lines
18-50; the mesh sharding rules of the decode state wait for ROADMAP
A.16b, on the spec rules of `repro_torch.sharding.specs`).
"""
from __future__ import annotations

import numpy as np
import torch


def make_prefill_step(model):
    def prefill(params, batch):
        logits, _ = model.apply(params, batch)
        return logits
    return prefill


def make_serve_step(model):
    def serve_step(params, state, tokens):
        return model.decode_step(params, state, tokens)
    return serve_step


def make_decode_dispatch(cfg, prompts, next_tokens):
    """The micro-batch dispatch for token models: prefill each request's
    prompt through `models.decode.decode_step` and score the greedy
    next-token prediction against `next_tokens`. `prompts` is the
    (n_examples, S) request corpus the traffic generator indexes into;
    returns per-request correctness (a numpy bool array). The requests
    run on the device that holds `params`."""
    from repro_torch.models import decode as decode_mod
    prompts = np.asarray(prompts)
    next_tokens = np.asarray(next_tokens)

    def dispatch(params, example_idx):
        ei = np.asarray(example_idx, np.int64)
        dev = params["embed"]["embed"].device
        toks = torch.as_tensor(prompts[ei], device=dev)
        out = decode_mod.greedy_generate(params, cfg, toks, num_steps=1)
        return out[:, -1].cpu().numpy() == next_tokens[ei]

    return dispatch
