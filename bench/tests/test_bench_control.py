"""The control: the reference in TF32 in the program's place fails the limit, the program passes.

At a size a test run holds, on three seeds, against the limits of the full
cells (``bench/limits/``); on the CPU, and on the card where there is one.
"""

import io

import pytest

from bench.control import readings
from bench.tests.tiny import make_root

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("control"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _check(summary):
    limits = summary["limits"]
    assert summary["program_max"]["structure_mismatch"] <= limits["structure_mismatch"]
    assert summary["program_max"]["value_gap"] <= limits["value_gap"]
    assert summary["control_min"]["value_gap"] > limits["value_gap"]


@pytest.mark.parametrize("workload", ["tiny_band.resident", "tiny_random.resident"])
def test_control_fails_and_program_passes_on_the_cpu(root, workload):
    _check(readings(workload, SEEDS, root=root, device="cpu", out=io.StringIO()))


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tiny_band.resident", "tiny_random.resident"])
def test_control_fails_and_program_passes_on_the_card(root, card, workload):
    _check(readings(workload, SEEDS, root=root, device=card, out=io.StringIO()))
