"""Twins of the reference's `examples/` scripts, run as
`python -m repro_torch.examples.<name>`: each takes the reference
script's flags, and those that touch a device take `--device` too (the
card unless `--device cpu`).

  quickstart                       train a reduced zoo config, checkpoint,
                                   generate
  federated_image_classification   the paper's FL experiment under any
                                   registered strategy, or a scenario
  serve_decode                     batched decode, the step replayed as
                                   one CUDA graph on the card
  multipod_dryrun_demo             the dry-run on the production meshes
"""
