"""Processes of a run: CPU readings from /proc and the teardown.

``cpu_seconds``, ``descendants`` and ``stop_children`` are copied from
``chip_smoke.py`` at commit 0ba68a39 (``stop_children`` without its
multiprocessing step: no run starts a multiprocessing helper);
``child_subreaper`` too, so that the daemons the topology's reconciler
starts stay below this process and are stopped with it.
"""
from __future__ import annotations

import ctypes
import os
import signal
import subprocess
import sys
import time

from portbench.harness import ROOT


def cpu_seconds(pid: int) -> float:
    """User + system CPU time of ``pid`` so far, from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(") ", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def descendants(pid: int):
    """Pids of every process below ``pid``, from /proc."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(") ", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), ()):
            out.append(child)
            todo.append(child)
    return out


def child_subreaper() -> bool:
    """Make this process the reaper of orphaned processes below it
    (Linux ``PR_SET_CHILD_SUBREAPER``)."""
    try:
        return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def stop_children():
    """Kill every process below this one, wait for each, and return the
    pids of any that are still there."""
    left = descendants(os.getpid())
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + 10
    for pid in left:
        while time.monotonic() < deadline:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break             # not ours: its own parent reaps it
            if done:
                break
            time.sleep(0.01)
    while descendants(os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.05)
    return descendants(os.getpid())


def spawn(args, log_path: str, env=None, **kw):
    """``python args...`` from the checkout's root, its output to
    ``log_path``."""
    with open(log_path, "wb") as out:
        return subprocess.Popen([sys.executable, *args], cwd=ROOT,
                                stdout=out, stderr=subprocess.STDOUT,
                                env=env, **kw)


def wait_line(proc, log_path: str, pattern, what: str, deadline_s: float):
    """The first match of regex ``pattern`` in ``proc``'s log, once it
    is there; RuntimeError if ``proc`` exits or ``deadline_s`` passes."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        with open(log_path, "rb") as f:
            m = pattern.search(f.read())
        if m:
            return m
        if proc.poll() is not None:
            raise RuntimeError(f"{what} exited {proc.returncode} before it "
                               f"was ready; its log: {tail(log_path)}")
        time.sleep(0.05)
    raise RuntimeError(f"{what} not ready in {deadline_s:.0f}s; its log: "
                       f"{tail(log_path)}")


def tail(path: str, n: int = 1500) -> str:
    try:
        with open(path, "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return ""
