"""``binder_torch.graft_entry`` on the GPU, held to its own CPU run.

These tests need a CUDA device: they carry the ``cuda`` marker and skip
with a reason where there is none.  Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.  The file imports
no JAX, so it runs where only the port is installed; the CPU tests in
``test_torch_graft_entry.py`` hold the CPU run to the JAX reference.
Tolerances: percentiles bit-exact (the same rule, evaluated on either
device), the float32 mean ``rtol=1e-6`` (the reduction order differs).
"""
import numpy as np
import pytest
import torch

from binder_torch import graft_entry

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("n", [4096, 100_001, (1 << 24) + 1])
def test_aggregate_on_cuda_matches_cpu(n):
    x = np.random.default_rng(n).lognormal(
        mean=5.0, sigma=1.0, size=n).astype(np.float32)
    on_gpu = graft_entry.aggregate(torch.from_numpy(x).cuda())
    assert all(v.device.type == "cuda" for v in on_gpu)
    mean, p50, p99 = (float(v) for v in on_gpu)
    c_mean, c50, c99 = (float(v) for v in graft_entry.aggregate(
        torch.from_numpy(x)))
    assert (p50, p99) == (c50, c99)
    assert mean == pytest.approx(c_mean, rel=1e-6)


def test_entry_example_lands_on_cuda():
    fn, (example,) = graft_entry.entry()
    assert example.device.type == "cuda"
    assert all(v.device.type == "cuda" for v in fn(example))


def test_allreduce_over_nccl():
    assert graft_entry.dryrun_multichip(1) is None
    assert graft_entry.run_ranks(1, "cuda") == [pytest.approx(0.5, rel=1e-6)]
