"""The card: its check, the program's device path, and its trace.

binder's served path does no device work.  The program's one device
path is ``binder_torch.graft_entry.aggregate``, the latency summary (mean,
p50, p99) that dashboards show; every run drives it once, on the
window's latencies, after the window, so that a traced run sees the
device do the program's work (no metric reads the summary).  A traced
run profiles the warm-up, the window and that summary, and samples
``nvidia-smi``'s utilization each second of the window, which counts
every process on the card.
"""
from __future__ import annotations

import subprocess
import time


class NoCard(RuntimeError):
    pass


class Card:
    def __init__(self):
        self.prof = None
        self.smi = None
        self.t_trace = None

    def check(self, chips: int) -> dict:
        """The card's name and count; NoCard unless CUDA has ``chips``
        devices."""
        import torch
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"{torch.cuda.device_count()} CUDA device(s), "
                         f"the cell needs {chips}")
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips}

    @staticmethod
    def power() -> str:
        try:
            return subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            return f"nvidia-smi: {e}"

    def trace_start(self) -> None:
        """Start the profiler; its start takes seconds, so a run calls
        this before its warm-up, and the traced span holds the warm-up,
        the window and the summary."""
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t_trace = time.monotonic()

    def util_start(self) -> None:
        """Sample the card's utilization each second, from the window's
        start."""
        self.smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "1000"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def util_stop(self):
        """The utilization samples (percent) since :meth:`util_start`."""
        self.smi.terminate()
        out, _ = self.smi.communicate(timeout=10)
        samples = []
        for line in out.splitlines():
            try:
                samples.append(float(line.strip()))
            except ValueError:
                continue
        return samples

    def summary(self, latencies_ms) -> dict:
        """The program's latency summary of the window, on the card."""
        import torch
        from binder_torch.graft_entry import aggregate
        x = torch.tensor(latencies_ms, dtype=torch.float32, device="cuda")
        mean, p50, p99 = aggregate(x)
        return {"mean_ms": float(mean), "p50_ms": float(p50),
                "p99_ms": float(p99), "n": len(latencies_ms)}

    def trace_stop(self) -> dict:
        """``busy_s``, ``window_s`` and the breakdown of the traced span:
        the union of the device's own events (kernels, copies, sets), so
        that a kernel is not counted again under the operator that
        launched it.  A span in which the profiler saw no device time
        is an error: the run prints no result."""
        from torch.autograd import DeviceType
        self.prof.__exit__(None, None, None)
        window_s = time.monotonic() - self.t_trace
        spans, by_name = [], {}
        for e in self.prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + (e.time_range.end - e.time_range.start) / 1e6
        busy_us, reach = 0.0, None
        for start, end in sorted(spans):
            if reach is None or start > reach:
                busy_us += end - start
                reach = end
            elif end > reach:
                busy_us += end - reach
                reach = end
        busy = busy_us / 1e6
        if busy <= 0:
            raise RuntimeError("the profiler saw no device time in the "
                               "traced span")
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        return {"busy_s": busy, "window_s": window_s,
                "device_ops": [list(kv) for kv in ops[:10]],
                "idle_gaps": [["serving DNS on the host (no device work)",
                               max(0.0, window_s - busy)]]}

    @staticmethod
    def memory_peak() -> int:
        import torch
        return int(torch.cuda.max_memory_allocated())
