"""The reference's compiled decode counts, a device, for the decode lines
of chip_smoke.py's 15(d) and tests/test_torch_decode_parallel.py: FLOPs,
peak bytes, collective bytes and count, and the collectives by kind and
result shape (`repro.launch.roofline._COLL_RE` over the compiled HLO).
Not collected by pytest; imports jax.

    PYTHONPATH=src python tests/torch_reference_decode.py

writes tests/fixtures/reference_decode.json (about 5 min on an 8-core
CPU). Each mesh's lines compile in a child process of its own, which
forces 256 (16x16) or 512 (2x16x16) host devices before importing jax,
and builds each step as the reference's `launch.dryrun.lower_and_compile`
does for a decode shape (its default overrides, the config's profile).
The card's host has no jax: chip_smoke.py reads the JSON."""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
OUT = os.path.join(HERE, "fixtures", "reference_decode.json")
COMMAND = "PYTHONPATH=src python tests/torch_reference_decode.py"

# (arch, shape, mesh): decode_32k on 16x16 for every config whose decode
# 15(d) prints, yi-9b's four lines and deepseek-v2-lite on 2x16x16
LINES = ([(a, "decode_32k", "16x16") for a in (
    "yi-9b", "phi3-mini-3.8b", "gemma3-4b", "qwen3-32b", "zamba2-1.2b",
    "seamless-m4t-large-v2", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
    "xlstm-125m")]
    + [("yi-9b", "long_500k", "16x16"), ("yi-9b", "decode_32k", "2x16x16"),
       ("yi-9b", "long_500k", "2x16x16"),
       ("deepseek-v2-lite-16b", "decode_32k", "2x16x16")])


def _compile_lines(lines):
    """[record] of `lines` (one mesh), in this process: jax already sees
    the mesh's devices."""
    import jax
    from repro.configs.base import INPUT_SHAPES
    from repro.configs.registry import get_config
    from repro.launch import dryrun
    from repro.launch import mesh as mesh_mod
    from repro.launch import roofline as rl
    from repro.launch import serve as serve_mod
    from repro.models.model import build_model
    from repro.sharding import specs as sh

    out = []
    for arch, shape_name, mesh_name in lines:
        t0 = time.perf_counter()
        cfg = dryrun._apply_overrides(get_config(arch), None)
        sh.set_profile(cfg.sharding_profile)
        sh.set_seq_shardable(set(cfg.layer_kinds()) == {"attn"})
        shape = INPUT_SHAPES[shape_name]
        mesh = mesh_mod.make_production_mesh(
            multi_pod=mesh_name == "2x16x16")
        model = build_model(cfg)

        def sds(tree, shardings):
            return jax.tree.map(lambda l, s: jax.ShapeDtypeStruct(
                l.shape, l.dtype, sharding=s), tree, shardings)
        ps = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        st = model.decode_state_specs(shape.global_batch, shape.seq_len)
        tok = model.decode_token_specs(shape.global_batch)
        args = (sds(ps, sh.tree_shardings(ps, mesh)),
                sds(st, serve_mod.decode_state_shardings(st, mesh, cfg)),
                jax.ShapeDtypeStruct(tok.shape, tok.dtype,
                                     sharding=serve_mod.token_shardings(
                                         tok, mesh)))
        with mesh_mod.activate_mesh(mesh):
            compiled = jax.jit(serve_mod.make_serve_step(model),
                               donate_argnums=(1,)).lower(*args).compile()
        roof = rl.analyze(compiled, mesh.size)
        mem = compiled.memory_analysis()
        by = {}
        for m in rl._COLL_RE.finditer(compiled.as_text()):
            tuple_part, dtype, dims, kind = m.groups()
            if tuple_part is not None:
                shape_txt = f"({tuple_part})"
                nbytes = sum(rl._shape_bytes(d, s)
                             for d, s in rl._SHAPE_RE.findall(tuple_part))
            else:
                shape_txt = f"{dtype}[{dims}]"
                nbytes = rl._shape_bytes(dtype, dims)
            row = by.setdefault((kind, shape_txt), {
                "kind": kind, "shape": shape_txt, "count": 0,
                "bytes": 0.0})
            row["count"] += 1
            row["bytes"] += nbytes * rl._WEIGHT[kind]
        out.append({
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "profile": cfg.sharding_profile, "chips": mesh.size,
            "flops": roof.flops_per_device,
            "argument_bytes": int(mem.argument_size_in_bytes),
            "temp_bytes": int(mem.temp_size_in_bytes),
            "peak_bytes": int(mem.argument_size_in_bytes
                              + mem.temp_size_in_bytes),
            "collective_bytes": roof.collective_bytes_per_device,
            "collective_count": roof.collective_count,
            "collectives": sorted(by.values(), key=lambda r: -r["bytes"]),
            "seconds": round(time.perf_counter() - t0, 1)})
        print(f"{arch} {shape_name} {mesh_name}: FLOPs "
              f"{roof.flops_per_device:.4g} peak "
              f"{out[-1]['peak_bytes'] / 1e9:.2f} GB collectives "
              f"{roof.collective_bytes_per_device / 1e9:.3f} GB "
              f"({out[-1]['seconds']} s)", file=sys.stderr, flush=True)
    return out


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        lines = [tuple(x) for x in json.loads(sys.argv[2])]
        print(json.dumps(_compile_lines(lines)))
        return
    records = []
    for mesh_name, devices in (("16x16", 256), ("2x16x16", 512)):
        lines = [x for x in LINES if x[2] == mesh_name]
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{devices}",
                   PYTHONPATH=SRC + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             json.dumps(lines)], env=env, stdout=subprocess.PIPE, text=True,
            check=True)
        records += json.loads(proc.stdout.strip().splitlines()[-1])
    import jax
    order = {x: i for i, x in enumerate(LINES)}
    records.sort(key=lambda r: order[(r["arch"], r["shape"], r["mesh"])])
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"command": COMMAND, "jax_version": jax.__version__,
                   "lines": records}, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}: {len(records)} lines")


if __name__ == "__main__":
    main()
