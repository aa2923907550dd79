"""On the card (``gpu``-marked; skips without one): each cell at its own
size is correct on a fresh seed and its control (the reference in
bfloat16 in the program's place) is not.  Run on the card with
``python -m pytest --noconftest -o addopts='' kppbench/tests/test_kppbench_gpu.py``
after ``sys.path`` holds the repository's root (run from the root)."""

import pytest
import torch

from kppbench import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_correct_and_control_fails(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(workload, 2**33 + 7, 5.0, False, control=True)
    assert r["correct"], r["checks"]
    assert not r["control"]["correct"], r["control"]
