"""The registrar: churn writes through the ZooKeeper stand-in, and the
freshness probe that times how soon each reaches every worker.

Copied in substance from ``chip_smoke.py``'s ``churn_main`` and
``probe_until`` at commit 0ba68a39: ``names`` host znodes are rewritten
round-robin at ``writes_per_s``, each write's address monotone in its
number.  Two changes for a measured window: every ``timed_every``-th
write is timed (an odd number, so the timed writes visit every name),
and many timed writes are probed at once.

Run as ``python -m portbench.harness.churn SPEC.json``.  SPEC holds the
stand-in's and the DNS service's ports, the churn settings of the mix,
the probe sockets (``groups``: for each worker, the ``[address, port]``
pairs that reach it) and the output directory.  It prints ``ready``,
then reads ``go <window start> <window end>`` (monotonic seconds) and
writes until the window ends or its standard input closes; then it waits for the timed writes still
open, checks that every name's last write reads back from every worker,
writes its logs and prints one JSON line.

A timed write is fresh once every worker has answered a probe with it or
a later write of the same name; its freshness is the time from the
stand-in's acknowledgement to that last answer.  Each worker is probed
every ``probe_period_s`` from the next of its sockets in turn, so that
no probe address passes the shipped response rate limit, and a round
asks at most ``probe_max_per_round`` questions, for the oldest writes
first, so that the probe's load stays bounded when freshness slips.
"""
from __future__ import annotations

import json
import os
import select
import socket
import struct
import sys
import threading
import time

import numpy as np

from portbench.harness import zone as zonemod
from portbench.harness.zkmini import ZKSession
from portbench.reference import dnswire

WRITE_DTYPE = np.dtype([("t_sent", "<f8"), ("t_ack", "<f8"), ("k", "<u4"),
                        ("w", "<u4")])
TIMED_DTYPE = np.dtype([("w", "<u4"), ("t_ack", "<f8"), ("t_fresh", "<f8")])
PROBE_DTYPE = np.dtype([("t_send", "<f8"), ("t_recv", "<f8"), ("k", "<u4"),
                        ("qid", "<u2"), ("len", "<u2"), ("off", "<u8")])


class Prober:
    """Probes open timed writes from every worker's sockets."""

    def __init__(self, spec: dict):
        self.domain = spec["domain"]
        self.names = spec["names"]
        self.period = spec["probe_period_s"]
        self.max_per_round = spec["probe_max_per_round"]
        self.limit = spec["fresh_limit_s"]
        self.groups = []
        for group in spec["groups"]:
            socks = []
            for addr, port in group:
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.bind((addr, port))
                s.connect(("127.0.0.1", spec["dns_port"]))
                s.setblocking(False)
                socks.append(s)
            self.groups.append(socks)
        self.sock_group = {s: g for g, socks in enumerate(self.groups)
                           for s in socks}
        self.turn = [0] * len(self.groups)
        self.lock = threading.Lock()
        #: [w, t_ack, groups still to read, freshness s, final check]
        self.open = []
        self.timed = []         # (w, t_ack, freshness s or nan)
        self.final = []         # the same, of each name's last write
        self.probes = []        # PROBE_DTYPE rows
        self.blob = bytearray()
        self.asked = {}         # (sock, qid) -> (k, t_send)
        self.qid = 0

    def add(self, w: int, t_ack: float, final: bool = False) -> None:
        with self.lock:
            self.open.append([w, t_ack, set(range(len(self.groups))), None,
                              final])

    def pending(self) -> int:
        with self.lock:
            return len(self.open)

    def _ask(self, k: int, group: int, now: float) -> None:
        socks = self.groups[group]
        s = socks[self.turn[group] % len(socks)]
        self.turn[group] += 1
        self.qid = (self.qid + 1) & 0xFFFF
        wire = dnswire.encode_query(zonemod.churn_name(k, self.domain),
                                    dnswire.A, self.qid)
        try:
            s.send(wire)
        except OSError:
            return
        self.asked[(s, self.qid)] = (k, now)

    def _read(self, s, now: float) -> None:
        while True:
            try:
                data = s.recv(65535)
            except (BlockingIOError, ConnectionRefusedError):
                return
            qid = struct.unpack_from(">H", data)[0] if len(data) >= 2 else -1
            asked = self.asked.pop((s, qid), None)
            if asked is None:
                continue
            k, t_send = asked
            self.probes.append((t_send, now, k, qid, len(data),
                                len(self.blob)))
            self.blob += data
            try:
                answers = dnswire.Reply(data).answers
            except dnswire.WireError:
                continue
            if len(answers) != 1 or answers[0][1] != dnswire.A:
                continue
            got = zonemod.churn_write(answers[0][3])
            group = self.sock_group[s]
            with self.lock:
                for item in self.open:
                    if item[0] % self.names == k and item[0] <= got:
                        item[2].discard(group)
                        if not item[2] and item[3] is None:
                            item[3] = now - item[1]

    def step(self) -> None:
        """One round: ask what is open, read what came, close what is
        fresh or past the limit."""
        now = time.monotonic()
        with self.lock:
            work = [(item[0] % self.names, g) for item in self.open
                    for g in item[2]]
        # the oldest first, and no more than the cap, so that a slow
        # deployment does not draw ever more probes
        for k, g in list(dict.fromkeys(work))[:self.max_per_round]:
            self._ask(k, g, now)
        deadline = now + self.period
        while True:
            wait = deadline - time.monotonic()
            if wait <= 0:
                break
            ready, _, _ = select.select(list(self.sock_group), [], [], wait)
            t = time.monotonic()
            for s in ready:
                self._read(s, t)
        t = time.monotonic()
        with self.lock:
            keep = []
            for item in self.open:
                w, t_ack, _, fresh, final = item
                if fresh is None and t - t_ack <= self.limit:
                    keep.append(item)
                    continue
                (self.final if final else self.timed).append(
                    (w, t_ack, float("nan") if fresh is None else fresh))
            self.open = keep

    def close(self) -> None:
        for socks in self.groups:
            for s in socks:
                s.close()


def rank_ms(fresh, q: float) -> float:
    """The nearest-rank percentile of the freshness of the timed writes,
    in ms; a write never read back counts as infinite."""
    from portbench.harness.stats import rank_percentile
    return rank_percentile(np.where(np.isnan(fresh), np.inf, fresh), q) * 1e3


def main(argv) -> int:
    with open(argv[1]) as f:
        spec = json.load(f)
    out = spec["out_dir"]
    names = spec["names"]
    domain = spec["domain"]
    interval = 1.0 / spec["writes_per_s"]
    every = spec["timed_every"]
    zk = ZKSession(spec["zk_port"])
    prober = Prober(spec)
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if len(line) != 3 or line[0] != "go":
        raise SystemExit("churn: expected 'go <start> <end>'")
    t_win, t_end = float(line[1]), float(line[2])

    done = threading.Event()
    closed = threading.Event()       # stdin closed: stop writing early
    threading.Thread(target=lambda: (sys.stdin.read(), closed.set()),
                     daemon=True).start()

    def probe_loop():
        while not done.is_set() or prober.pending():
            prober.step()

    thread = threading.Thread(target=probe_loop, daemon=True)
    thread.start()
    writes = []
    last = {}
    w = 0
    t_next = time.monotonic()
    while True:
        now = time.monotonic()
        if now >= t_end or closed.is_set():
            break
        if now < t_next:
            time.sleep(t_next - now)
        k = w % names
        t_sent = time.monotonic()
        zk.set_data(zonemod.churn_path(k, domain),
                    zonemod.host_json(zonemod.churn_addr(w)))
        t_ack = time.monotonic()
        writes.append((t_sent, t_ack, k, w))
        last[k] = w
        if w % every == 0 and t_win <= t_ack < t_end:
            prober.add(w, t_ack)
        w += 1
        t_next += interval
    zk.close()
    # every name's last write, read back from every worker
    for k, wl in sorted(last.items()):
        prober.add(wl, time.monotonic(), final=True)
    done.set()
    thread.join()
    timed = np.array(prober.timed, TIMED_DTYPE)
    final = np.array(prober.final, TIMED_DTYPE)
    np.array(writes, WRITE_DTYPE).tofile(os.path.join(out, "writes.bin"))
    timed.tofile(os.path.join(out, "timed.bin"))
    np.array(prober.probes, PROBE_DTYPE).tofile(
        os.path.join(out, "probes.bin"))
    with open(os.path.join(out, "probes.rep"), "wb") as f:
        f.write(prober.blob)
    prober.close()
    print(json.dumps({
        "writes": len(writes), "timed": int(len(timed)),
        "stale": int(np.isnan(timed["t_fresh"]).sum()),
        "final_unread": int(np.isnan(final["t_fresh"]).sum()),
        "probes": len(prober.probes),
        "fresh_p50_ms": rank_ms(timed["t_fresh"], 50),
        "fresh_p99_ms": rank_ms(timed["t_fresh"], 99)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
