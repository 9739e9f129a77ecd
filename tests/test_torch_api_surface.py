"""`repro_torch.api`: the reference's public surface from the port's own
modules — the same sorted `__all__`, each name bound to the port's object
(never the reference's), the registries holding the reference's strategy
and codec names with the same declarations, and the same schema
constants."""
import importlib

import pytest

pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro_torch import api  # noqa: E402


def test_api_surface_equals_the_reference():
    assert api.__all__ == ref_api.__all__
    assert len(api.__all__) == 34


@pytest.mark.parametrize("name", ref_api.__all__)
def test_api_name_is_the_ports_own(name):
    obj = getattr(api, name)
    module = getattr(obj, "__module__", None) or getattr(obj, "__name__", "")
    if isinstance(obj, (tuple, list, dict, int, float, str)):
        return                                # constants: compared below
    assert module.startswith("repro_torch."), (name, module)


def test_api_registry_contents():
    assert set(api.strategy_names()) == set(ref_api.strategy_names())
    for name in api.strategy_names():
        cls, ref = api.get_strategy(name), ref_api.get_strategy(name)
        assert issubclass(cls, api.Strategy) and cls.name == name
        assert tuple(cls.topologies) == tuple(ref.topologies)
        assert {k: tuple(v) for k, v in cls.defenses.items()} == {
            k: tuple(v) for k, v in ref.defenses.items()}
    assert set(api.codec_names()) == set(ref_api.codec_names())
    for name in api.codec_names():
        cls = api.get_codec(name)
        assert issubclass(cls, api.Codec) and cls.name == name
        assert cls.defenses


def test_api_schema_constants():
    assert api.RESULT_SCHEMA_VERSION == ref_api.RESULT_SCHEMA_VERSION == 2.5
    assert api.STRATEGY_REGISTRY_VERSION == ref_api.STRATEGY_REGISTRY_VERSION
    assert api.CODEC_REGISTRY_VERSION == ref_api.CODEC_REGISTRY_VERSION
    assert tuple(api.CI_SMOKE_GRID) == tuple(ref_api.CI_SMOKE_GRID)
    for name in ("ATTACKS", "DEFENSES", "ENGINES", "STRATEGIES"):
        assert tuple(getattr(api, name)) == tuple(getattr(ref_api, name))
    assert sorted(api.scenario_names()) == sorted(ref_api.scenario_names())


def test_api_objects_are_the_modules_objects():
    sim = importlib.import_module("repro_torch.core.simulation")
    assert api.FederatedSimulation is sim.FederatedSimulation
    assert api.ops is importlib.import_module("repro_torch.core.aggregation")
