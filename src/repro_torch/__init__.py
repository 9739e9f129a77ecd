"""PyTorch/CUDA port of the federated-learning simulator (`repro`).

The package mirrors the reference layout (`core/`, `data/`, `kernels/`,
`models/`, `obs/`, `optim/`) and keeps its `FLConfig` fields, strategy
names and result fields, so one config means the same run in either
package. It imports torch, numpy and the standard library only: never
jax and never `repro`.

Slice 1 covers the paper study: `FederatedSimulation` with the HFL, AFL
and CFL strategies on the §2.4 CNN under the `loop` and `vectorized`
engines, with every aggregation event on the hand-written CUDA
`fedavg_agg` kernel (`kernels/csrc/fedavg_agg.cu`). Entry points run on
the card unless the caller passes `device="cpu"` (`device.py`).
"""
