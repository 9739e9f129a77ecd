"""repro_torch.data against the reference: for the same seed the
synthetic datasets and the client partitions are bitwise equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data import partition as ref_part  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro_torch.data import partition as port_part  # noqa: E402
from repro_torch.data import synthetic as port_syn  # noqa: E402

SEEDS = (0, 1, 7)


@pytest.mark.parametrize("name", ["mnist", "fashion"])
@pytest.mark.parametrize("seed", SEEDS)
def test_datasets_bitwise(name, seed):
    ref = ref_syn.DATASETS[name](seed=seed, n_train=300, n_test=100)
    port = port_syn.DATASETS[name](seed=seed, n_train=300, n_test=100)
    assert port["name"] == ref["name"]
    for split in ("train", "test"):
        for a, b in zip(ref[split], port[split]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_iid_partition_bitwise(seed):
    labels = np.random.default_rng(seed).integers(0, 10, 1000)
    for a, b in zip(ref_part.iid_partition(labels, 8, seed=seed),
                    port_part.iid_partition(labels, 8, seed=seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_dirichlet_partition_bitwise(seed):
    labels = np.random.default_rng(seed).integers(0, 10, 1000)
    ref = ref_part.dirichlet_partition(labels, 6, alpha=0.5, seed=seed)
    port = port_part.dirichlet_partition(labels, 6, alpha=0.5, seed=seed)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a, b)
