"""The load client: its build under ``portbench/_build/`` and its runs.

The client is ``portbench/client/blast.cpp``, compiled once per source
and flags into a directory named by their hash, under a lock, so that
only the first run in a checkout compiles it.
"""
from __future__ import annotations

import fcntl
import hashlib
import json
import os
import subprocess

import numpy as np

from portbench.harness import BUILD_DIR, ROOT

SOURCE = os.path.join(ROOT, "portbench", "client", "blast.cpp")
FLAGS = ("-O2", "-g", "-Wall", "-Wextra", "-std=c++17")

#: one query sent; ``struct Rec`` in blast.cpp
REC_DTYPE = np.dtype([("entry", "<u4"), ("retries", "<u2"),
                      ("answered", "u1"), ("rcode", "u1"), ("tc", "u1"),
                      ("qmatch", "u1"), ("reply_len", "<u2"),
                      ("t_due", "<f8"), ("t_sent", "<f8"),
                      ("t_reply", "<f8"), ("reply_off", "<u8")])


def build() -> str:
    """The client binary, compiled if this source and these flags have
    not been compiled in this checkout before."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + repr(FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_DIR, f"blast-{key}")
    binary = os.path.join(out_dir, "blast")
    if os.path.exists(binary):
        return binary
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(binary):
            os.makedirs(out_dir, exist_ok=True)
            tmp = binary + ".tmp"
            subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp], check=True)
            os.replace(tmp, binary)
    return binary


class Clients:
    """``procs`` client processes over one schedule, each waiting for
    the window's start once it has bound its sockets."""

    def __init__(self, binary: str, port: int, files: dict, mix: dict,
                 seconds: float, out_prefix: str, grace_s=None):
        self.procs = []
        self.out = []
        n = int(mix["client_procs"])
        inflight = int(mix.get("inflight") or 1)
        for i in range(n):
            prefix = f"{out_prefix}.{i}"
            args = [binary, "-p", str(port), "-t", files["templates"],
                    "-q", files["schedule"], "-a", files["sources"],
                    "-m", mix["loop"], "-w", str(max(1, inflight // n)),
                    "-d", repr(seconds), "-r", repr(mix["retry_s"]),
                    "-g", repr(mix["grace_s"] if grace_s is None
                               else grace_s),
                    "-P", str(n), "-I", str(i),
                    "-o", prefix]
            self.procs.append(subprocess.Popen(
                args, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                cwd=ROOT))
            self.out.append(prefix)
        for p in self.procs:
            if p.stdout.readline().strip() != b"ready":
                raise RuntimeError("load client did not start")

    def pids(self) -> dict:
        return {f"client{i}": p.pid for i, p in enumerate(self.procs)}

    def go(self, t0: float) -> None:
        for p in self.procs:
            p.stdin.write(f"go {t0!r}\n".encode())
            p.stdin.close()

    def finish(self, timeout: float):
        """``(records, replies blob, totals of each process)``: every
        process's records in one array, ``reply_off`` into the joined
        blob."""
        totals, recs, blobs, base = [], [], [], 0
        for p, prefix in zip(self.procs, self.out):
            out = p.stdout.read()
            if p.wait(timeout=timeout) != 0:
                raise RuntimeError(f"load client exited {p.returncode}")
            totals.append(json.loads(out.decode().strip().splitlines()[-1]))
            rec = np.fromfile(prefix + ".rec", REC_DTYPE)
            with open(prefix + ".rep", "rb") as f:
                blob = f.read()
            kept = rec["reply_off"] != np.iinfo(np.uint64).max
            rec["reply_off"][kept] += base
            base += len(blob)
            recs.append(rec)
            blobs.append(blob)
        return np.concatenate(recs), b"".join(blobs), totals
