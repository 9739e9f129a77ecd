"""The card-to-card gather of ranks that share a card
(`launch.mesh.card_plan` laid out as `collectives.card_gather` fills it)
against `gather`'s own semantics: one all-gather a sharded dim, over the
dim's axes in axis order, kept axes left sharded. The geometry runs here
on the CPU for every rank of a (data 4, model 2) mesh with no process
behind it; the copies through CUDA IPC run only on the card (chip_smoke
phase 15, whose gates compare the sharded steps with the single-device
ones)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import RankMesh, _gathered_dims  # noqa: E402
from repro_torch.launch.mesh import card_plan, shard  # noqa: E402
from repro_torch.sharding.specs import P, MeshShape, NamedSharding  # noqa: E402,E501

MESH = MeshShape((4, 2), ("data", "model"))
WORLD = 8
CASES = [
    ((8, 6), P("data", "model"), ()),
    ((8, 6), P("data", "model"), ("data",)),
    ((16, 3), P(("data", "model")), ()),
    ((16, 3), P(("data", "model")), ("data",)),
    ((4, 8, 2), P(None, ("model", "data")), ()),
    ((6, 4), P(None, "model"), ("data",)),
    ((5, 3), P(), ()),
]


def _simulated_gather(shards, sharding, keep):
    """Every rank's `gather` result, each all-gather simulated as the
    concatenation of its members' blocks in axis order."""
    meshes = {r: RankMesh(MESH, r, WORLD, dry=True) for r in range(WORLD)}
    xs = dict(shards)
    for d, rest in _gathered_dims(sharding, keep):
        xs = {r: torch.cat([xs[m] for m in meshes[r].axis(rest).members], d)
              for r in range(WORLD)}
    return xs


@pytest.mark.parametrize("shape,spec,keep", CASES)
def test_card_plan_lays_blocks_as_gather(shape, spec, keep):
    full = torch.arange(torch.Size(shape).numel(),
                        dtype=torch.float32).reshape(shape)
    sharding = NamedSharding(MESH, spec)
    shards = {r: shard(full, sharding, RankMesh(MESH, r, WORLD, dry=True))
              for r in range(WORLD)}
    want = _simulated_gather(shards, sharding, keep)
    for r in range(WORLD):
        plan = card_plan(shards[r], sharding,
                         RankMesh(MESH, r, WORLD, dry=True), keep)
        if plan is None:
            assert not _gathered_dims(sharding, keep)
            assert torch.equal(shards[r], want[r])
            continue
        _, out_shape, places, kind_bytes = plan
        out = torch.full(out_shape, float("nan"))
        for j, where in places:
            out[where] = shards[j]
        assert torch.equal(out, want[r]), (r, spec, keep)
        assert r in [j for j, _ in places]
        assert kind_bytes[-1] == out.numel() * out.element_size()
        assert len(kind_bytes) == len(_gathered_dims(sharding, keep))
