"""Quickstart (twin of `examples/quickstart.py`): build any assigned
architecture, train it on a synthetic LM task, checkpoint, and generate.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        --arch gemma3-4b --steps 30 [--device cpu]
"""
import argparse
import os
import tempfile


def main(argv=None):
    """Run the quickstart; returns {"cfg", "history", "path", "params",
    "restored", "generated"} ("generated" is None for configs that need
    modality inputs)."""
    import torch

    from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import train_loop
    from repro_torch.models.decode import greedy_generate
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_quickstart"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # reduced variant of the full config: same family, laptop-runnable
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    print(f"arch={cfg.name} ({cfg.arch_type}), reduced: "
          f"{cfg.num_layers}L d={cfg.d_model} vocab={cfg.vocab_size}")

    params, history = train_loop(model, steps=args.steps, batch=args.batch,
                                 seq_len=args.seq_len, device=dev)
    if not history[-1][1] < history[0][1]:
        raise RuntimeError(f"loss did not improve: {history}")
    print(f"loss: {history[0][1]:.3f} -> {history[-1][1]:.3f}")

    path = save_checkpoint(args.ckpt_dir, args.steps, params,
                           extra_meta={"arch": cfg.name})
    print(f"checkpointed -> {path}")
    restored = restore_checkpoint(path, tree_map(torch.zeros_like, params))

    generated = None
    if cfg.modality == "text" and not cfg.encoder_layers:
        prompt = torch.tensor([[1, 2, 3, 4]], dtype=torch.long, device=dev)
        generated = greedy_generate(restored, cfg, prompt, num_steps=12)
        print("greedy continuation:", generated[0].tolist())
    return {"cfg": cfg, "history": history, "path": path, "params": params,
            "restored": restored, "generated": generated}


if __name__ == "__main__":
    main()
