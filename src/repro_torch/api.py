"""repro_torch.api — the stable public surface of the port, the same 33
names as `repro.api` (tests/test_torch_api_surface.py holds the two
equal), each from the port's own modules:

  Configuration    FLConfig, ATTACKS, DEFENSES, ENGINES, STRATEGIES
  Strategy plugins Strategy, RoundPlan, LocalSpec, register_strategy,
                   get_strategy, strategy_names, STRATEGY_REGISTRY,
                   STRATEGY_REGISTRY_VERSION
  Upload codecs    Codec, register_codec, get_codec, codec_names,
                   CODEC_REGISTRY, CODEC_REGISTRY_VERSION
  Driver           FederatedSimulation, FLResult
  Scenarios        ScenarioSpec, register_scenario, get_scenario,
                   scenario_names, run_scenario, load_result,
                   RESULT_SCHEMA_VERSION, CI_SMOKE_GRID, output_path
  Aggregation ops  ops (`repro_torch.core.aggregation`)
  Observability    Telemetry, write_chrome_trace, validate_chrome_trace

A plugin registers as in the reference:

    from repro_torch import api

    @api.register_strategy
    class MyStrategy(api.Strategy):
        name = "my-strategy"
        ...

    api.run_scenario(api.ScenarioSpec(
        "mine", "demo", strategy="my-strategy", topology="star"))

Entry points run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

from repro_torch.core import aggregation as ops
from repro_torch.core.codecs import (CODEC_REGISTRY, CODEC_REGISTRY_VERSION,
                                     Codec, codec_names, get_codec,
                                     register_codec)
from repro_torch.core.fl_types import (ATTACKS, DEFENSES, ENGINES,
                                       STRATEGIES, FLConfig)
from repro_torch.core.scenarios import (CI_SMOKE_GRID, RESULT_SCHEMA_VERSION,
                                        ScenarioSpec, load_result,
                                        output_path, run_scenario)
from repro_torch.core.scenarios import get as get_scenario
from repro_torch.core.scenarios import names as scenario_names
from repro_torch.core.scenarios import register as register_scenario
from repro_torch.core.simulation import FederatedSimulation, FLResult
from repro_torch.core.strategies import (STRATEGY_REGISTRY,
                                         STRATEGY_REGISTRY_VERSION,
                                         LocalSpec, RoundPlan, Strategy,
                                         get_strategy, register_strategy,
                                         strategy_names)
from repro_torch.obs import (Telemetry, validate_chrome_trace,
                             write_chrome_trace)

__all__ = sorted([
    "ATTACKS", "DEFENSES", "ENGINES", "STRATEGIES", "FLConfig",
    "Strategy", "RoundPlan", "LocalSpec", "register_strategy",
    "get_strategy", "strategy_names", "STRATEGY_REGISTRY",
    "STRATEGY_REGISTRY_VERSION",
    "Codec", "register_codec", "get_codec", "codec_names",
    "CODEC_REGISTRY", "CODEC_REGISTRY_VERSION",
    "FederatedSimulation", "FLResult",
    "ScenarioSpec", "register_scenario", "get_scenario", "scenario_names",
    "run_scenario", "load_result", "RESULT_SCHEMA_VERSION",
    "CI_SMOKE_GRID", "output_path",
    "Telemetry", "write_chrome_trace", "validate_chrome_trace",
    "ops",
])
