"""Parity of ``binder_torch.graft_entry`` with ``__graft_entry__``.

The same seeded numpy batches go through the JAX ``aggregate`` (jitted,
on the CPU) and the port's torch ``aggregate`` (on the CPU).  Tolerances:

- p50 / p99: bit-exact against ``jnp.percentile``.  The port transcribes
  the reference rule (float32 rank, float32 ``n``, the low term fused
  into the add as XLA fuses it), so no tolerance is needed.
- mean: ``rtol=1e-6``.  Both sum float32 in a different order.
- at 2**24 + 1 samples, against ``np.percentile`` as well: the reference
  rounds ``n`` to float32 (2**24), so its rank sits up to one position
  from numpy's float64 rank; the value must lie within the order
  statistics one position either side of numpy's rank.
- the all-reduce mean of ``linspace(0, 1, 8n)``: ``rtol=1e-6`` against
  the float32 numpy mean.
"""
import multiprocessing

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref
from binder_torch import graft_entry as port

MEAN_RTOL = 1e-6


def _batch(kind, n):
    rng = np.random.default_rng(n)
    if kind == "example":
        return ref.entry()[1][0]
    if kind == "uniform":
        return rng.random(n).astype(np.float32)
    return rng.lognormal(mean=5.0, sigma=1.0, size=n).astype(np.float32)


def _port_aggregate(x):
    return [float(v) for v in port.aggregate(torch.from_numpy(x))]


def _jax_aggregate(x):
    fn, _ = ref.entry()
    return [np.float32(v) for v in jax.jit(fn)(x)]


@pytest.mark.parametrize("kind,n", [("example", 4096),
                                    ("uniform", 100_001),
                                    ("lognormal", 1 << 20)])
def test_aggregate_matches_jax(kind, n):
    x = _batch(kind, n)
    assert x.shape == (n,)
    mean, p50, p99 = _port_aggregate(x)
    j_mean, j50, j99 = _jax_aggregate(x)
    assert np.float32(p50) == j50
    assert np.float32(p99) == j99
    assert mean == pytest.approx(float(j_mean), rel=MEAN_RTOL)


def test_aggregate_matches_jax_on_seeded_sizes():
    """Many small batches: where the rank falls between two samples the
    two interpolation forms round apart on a share of inputs, so a
    sweep catches an unfused or float64-ranked port that the fixed
    sizes above may not."""
    rng = np.random.default_rng(2024)
    for n in rng.integers(2, 5000, size=40):
        x = _batch("uniform" if n % 2 else "lognormal", int(n))
        _, p50, p99 = _port_aggregate(x)
        _, j50, j99 = _jax_aggregate(x)
        assert (np.float32(p50), np.float32(p99)) == (j50, j99), n


def test_aggregate_above_quantile_limit():
    """2**24 + 1 samples: past ``torch.quantile``'s input limit."""
    n = (1 << 24) + 1
    x = _batch("lognormal", n)
    mean, p50, p99 = _port_aggregate(x)
    j_mean, j50, j99 = _jax_aggregate(x)
    assert (np.float32(p50), np.float32(p99)) == (j50, j99)
    assert mean == pytest.approx(float(j_mean), rel=MEAN_RTOL)
    assert mean == pytest.approx(float(np.mean(x, dtype=np.float64)),
                                 rel=MEAN_RTOL)
    ordered = np.sort(x)
    for q, got in ((50.0, p50), (99.0, p99)):
        r = q / 100 * (n - 1)
        lo = ordered[int(np.floor(r)) - 1]
        hi = ordered[int(np.ceil(r)) + 1]
        assert lo <= got <= hi, (q, got, float(np.percentile(x, q)))


def test_aggregate_nan_batch_is_nan():
    x = _batch("uniform", 1000)
    x[17] = np.nan
    got = _port_aggregate(x)
    want = _jax_aggregate(x)
    assert all(np.isnan(v) for v in got)
    assert all(np.isnan(v) for v in want)


def test_entry_needs_a_device():
    if torch.cuda.is_available():
        _, (example,) = port.entry()
        assert example.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.entry()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.dryrun_multichip(1)
    fn, (example,) = port.entry(device="cpu")
    assert example.device.type == "cpu"
    np.testing.assert_array_equal(example.numpy(), ref.entry()[1][0])
    assert fn is port.aggregate


@pytest.mark.parametrize("n", [2, 4])
def test_allreduce_mean_matches_reference(n):
    means = port.run_ranks(n, "cpu")
    x = np.linspace(0.0, 1.0, 8 * n, dtype=np.float32)
    assert means == pytest.approx([float(np.mean(x))] * n, rel=MEAN_RTOL)
    assert port.dryrun_multichip(n, device="cpu") is None
    # the reference's own step, on the 8 host devices conftest forces
    # (initialising the backend first keeps it from shrinking the mesh
    # to this case's n, whatever test ran before)
    assert len(jax.devices()) >= n
    assert ref.dryrun_multichip(n) is None


def test_ranks_past_their_deadline_are_killed():
    with pytest.raises(TimeoutError, match="still running"):
        port.run_ranks(2, "cpu", timeout_s=0.2)
    assert not [p for p in multiprocessing.active_children()
                if p.is_alive()]
