"""Latency summary and data-parallel all-reduce, in PyTorch on the GPU.

Counterpart of the JAX entry points in ``__graft_entry__.py``.  binder has
no tensor workload (SURVEY.md §7.0); the one numeric computation it runs
is the summary of a batch of per-query latencies:

- :func:`entry` returns ``(aggregate, example)``: ``aggregate(samples)``
  gives ``(mean, p50, p99)`` of a float32 batch on the tensor's own
  device, with ``jnp.percentile``'s linear interpolation rule.
- :func:`dryrun_multichip` runs one data-parallel step of the mean over
  ``n`` ranks: each takes its shard, and an ``all_reduce`` adds up the
  sums and counts (NCCL on the GPU, gloo when the caller asks for the
  CPU).

Both run on the GPU unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit device they raise rather than fall back.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PERCENTILES = (50.0, 99.0)


def _device(device: Optional[str]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def percentile(sorted_samples: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(samples, q)`` (linear) of an ascending 1-D batch.

    Transcribes the reference's rule rather than calling
    ``torch.quantile``, whose rank and interpolation round differently
    in the last bit (and which refuses more than 2**24 elements):

    - the rank is ``q / 100 * (n - 1)`` in float32, with ``n`` itself
      rounded to float32 (so 2**24 + 1 samples rank as 2**24);
    - the value is ``low * (1 - w) + high * w`` with the first product
      fused into the add, as XLA fuses it: evaluated in float64, where
      the float32 product is exact, and rounded back to float32.
    """
    n = np.float32(sorted_samples.numel())
    rank = np.float32(q) / np.float32(100) * (n - np.float32(1))
    low, high = np.floor(rank), np.ceil(rank)
    high_w = rank - low
    low_w = np.float32(1) - high_w
    last = int(n) - 1
    lo = sorted_samples[min(max(int(low), 0), last)]
    hi = sorted_samples[min(max(int(high), 0), last)]
    value = (lo.double() * float(low_w)
             + (hi * float(high_w)).double()).to(sorted_samples.dtype)
    # the reference answers NaN for a batch holding any NaN; an
    # ascending sort puts NaNs last
    return torch.where(torch.isnan(sorted_samples[-1]),
                       sorted_samples[-1], value)


def aggregate(samples: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean, p50, p99)`` of a 1-D float32 batch, on its own device."""
    ordered = torch.sort(samples.reshape(-1)).values
    p50, p99 = (percentile(ordered, q) for q in PERCENTILES)
    return torch.mean(samples), p50, p99


def entry(device: Optional[str] = None):
    """Return ``(aggregate, example_args)``; the example is the
    reference's 4096-sample batch, placed on ``device`` (CUDA unless
    the caller asks for another)."""
    dev = _device(device)
    example = np.abs(np.linspace(0.1, 2.0, 4096, dtype=np.float32))
    return aggregate, (torch.from_numpy(example).to(dev),)


def local_step(rank: int, world_size: int, device_type: str,
               init_method: str) -> float:
    """One rank of the data-parallel mean over ``linspace(0, 1, 8n)``:
    this rank's shard sum and count, all-reduced over the group.
    Returns the global mean every rank sees."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    try:
        dev = (torch.device("cuda", rank) if device_type == "cuda"
               else torch.device("cpu"))
        x = np.linspace(0.0, 1.0, 8 * world_size, dtype=np.float32)
        shard = torch.from_numpy(x[8 * rank:8 * (rank + 1)]).to(dev)
        parts = torch.stack([shard.sum(),
                             torch.ones_like(shard).sum()])
        dist.all_reduce(parts)
        return float(parts[0] / parts[1])
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, world_size: int, device_type: str,
               init_method: str, out) -> None:
    out.put((rank, local_step(rank, world_size, device_type,
                              init_method)))


def run_ranks(n_devices: int, device_type: str,
              timeout_s: float = 300.0) -> List[float]:
    """Spawn ``n_devices`` ranks of :func:`local_step`; return each
    rank's reduced mean, in rank order.  Ranks still running after
    ``timeout_s`` (a hung rendezvous or collective) are killed and
    ``TimeoutError`` is raised."""
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ranks = mp.start_processes(
            _rank_main, nprocs=n_devices,
            args=(n_devices, device_type, init_method, out),
            join=False, start_method="spawn")
        try:
            while not ranks.join(timeout=max(
                    0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        "%d rank(s) still running after %gs"
                        % (n_devices, timeout_s))
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
    means = dict(out.get() for _ in range(n_devices))
    return [means[r] for r in range(n_devices)]


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """Run one data-parallel step of the mean on ``n_devices`` ranks.

    Raises if fewer devices are visible than asked for, or if the
    reduced mean is not finite."""
    dev = _device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            "dryrun_multichip(%d): only %d CUDA device(s) visible"
            % (n_devices, torch.cuda.device_count()))
    for mean in run_ranks(n_devices, dev.type):
        if not math.isfinite(mean):
            raise RuntimeError(
                "dryrun_multichip(%d): non-finite mean %r"
                % (n_devices, mean))


if __name__ == "__main__":
    fn, args = entry()
    print("entry:", [float(v) for v in fn(*args)])
    n = torch.cuda.device_count()
    dryrun_multichip(n)
    print("dryrun_multichip(%d): ok; reduced means %s"
          % (n, run_ranks(n, "cuda")))
