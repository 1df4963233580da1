"""Each cell's control on the card: the program in the precision below its
configuration's (the class cell's bf16 decode and a bf16 reference in the
program's place; TF32 products for training) fails at least one of the
cell's limits, while the sound program passes them, on three seeds each
with a short window. Needs a CUDA device; run on the card with

    python3 -m pytest -m cuda portbench/tests/test_portbench_control.py
"""

import pytest
import torch

from portbench import control, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs on the card")
    limits = harness.cell_files(name)[1]["limits"]
    for seed, numbers, _ in control.readings(name, [11, 12, 13], 2.0, True):
        assert not harness.judge(numbers, limits)[0], (seed, numbers)
    for seed, numbers, _ in control.readings(name, [14, 15, 16], 2.0, False):
        assert harness.judge(numbers, limits)[0], (seed, numbers)
