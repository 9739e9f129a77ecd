"""Serving example (twin of `examples/serve_decode.py`): batched
autoregressive decoding with per-layer-kind caches (full KV /
sliding-window ring / MLA latent / SSM state).

The reference compiles the step (`jax.jit(model.decode_step)`); here the
step is `launch.serve.make_graphed_serve_step`: on the card, one CUDA
graph of `decode_step` replayed step after step, the state advanced in
place (on the CPU the same in-place step runs eagerly).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        --arch zamba2-1.2b [--device cpu]
"""
import argparse
import time


def main(argv=None):
    """Run the example; returns {"cfg", "params", "prompt", "tokens",
    "index", "prefill_s", "decode_s"} (tokens: (B, prompt + gen))."""
    import torch

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.device import generator, resolve_device
    from repro_torch.launch.serve import make_graphed_serve_step
    from repro_torch.models.model import build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))

    cfg = get_config(args.arch).reduced()
    if cfg.encoder_layers or cfg.modality != "text":
        print(f"{args.arch} needs modality inputs; using phi3-mini instead")
        cfg = get_config("phi3-mini-3.8b").reduced()
    model = build_model(cfg)
    params = model.init(generator(0), dev)

    B = args.batch
    cap = args.prompt_len + args.gen_len
    state = model.init_decode_state(B, cap, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                           generator=generator(1)).to(dev)

    # prefill (token-by-token through the decode path at example scale);
    # the capture stands where the reference's first call compiles
    tok = prompt[:, :1]
    t0 = time.perf_counter()
    step = make_graphed_serve_step(model, params, state, tok)
    for t in range(args.prompt_len):
        logits, state = step(params, state, tok)
        tok = (prompt[:, t + 1:t + 2] if t + 1 < args.prompt_len
               else torch.argmax(logits[:, -1:], -1))
    sync()
    t_prefill = time.perf_counter() - t0

    seqs = [prompt]
    t0 = time.perf_counter()
    for _ in range(args.gen_len):
        seqs.append(tok)
        logits, state = step(params, state, tok)
        tok = torch.argmax(logits[:, -1:], -1)
    sync()
    t_decode = time.perf_counter() - t0

    out = torch.cat(seqs, dim=1)
    index = int(state["index"])
    print(f"arch={cfg.name}  batch={B}")
    print(f"prefill: {args.prompt_len} tokens in {t_prefill:.2f}s")
    print(f"decode:  {args.gen_len} steps in {t_decode:.2f}s "
          f"({1e3 * t_decode / args.gen_len:.1f} ms/step/batch)")
    for b in range(min(B, 2)):
        print(f"  seq[{b}]: {out[b].tolist()}")
    print(f"cache index: {index} (== {cap - 1 + 1} writes)")
    return {"cfg": cfg, "params": params, "prompt": prompt, "tokens": out,
            "index": index, "prefill_s": t_prefill, "decode_s": t_decode}


if __name__ == "__main__":
    main()
