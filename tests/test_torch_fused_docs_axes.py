"""Result documents of `attack-signflip-median-fused` (corruption and the
median inside the fused round) and `churn-afl-gossip-mtd` (the fault
schedule as per-round inputs) against the reference's, from its initial
parameters, on the CPU; held as in test_torch_fused_docs.py."""
import pytest

pytest.importorskip("torch")

from test_torch_fused_docs import assert_doc_matches, doc_pair  # noqa: E402


@pytest.mark.parametrize("name", ["attack-signflip-median-fused",
                                  "churn-afl-gossip-mtd"])
def test_fused_axis_document_matches_the_reference(name):
    ref, port = doc_pair(name)
    assert_doc_matches(ref, port)
    if name.startswith("churn"):
        assert port["faults"]["events_logged"] == port["spec"]["rounds"]
    else:
        assert port["attack"]["defense"] == "median"
