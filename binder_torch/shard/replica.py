"""ReplicaStore: a shard worker's view of the one owner mirror.

In shard mode exactly ONE process — the supervisor — holds the ZK
session and the store mirror; workers never open a store connection.
Instead each worker runs this :class:`ReplicaStore`: a
:class:`~binder_torch.store.fake.FakeStore` (so the whole StoreClient
surface — watchers, initial-state-on-attach, session callbacks — works
unchanged) whose tree is mutated ONLY by mutation-log frames read from
the supervisor socketpair.  The worker's own ``MirrorCache`` sits on
top and re-derives everything a single-process binder would — TreeNode
tree, reverse (PTR) map, generation bumps, per-name invalidation tags
feeding the precompiler and the native caches — from the replayed
deltas, so N shards serve byte-identical answers off one watch load.

Lifecycle:

- ``read_snapshot()`` (blocking, before the serve stack exists)
  consumes the attach-time snapshot: a session ``state`` frame, one
  ``node`` frame per mirrored name, ``snap-end``.  A respawned shard
  catches up exactly this way — snapshot + replay IS the recovery
  story.
- ``start(loop)`` switches the fd to non-blocking delta reading;
  every applied frame fires the same watcher events a local store
  mutation would.
- Supervisor session transitions arrive as ``state`` frames (0.5 s
  heartbeat + edge-triggered): the replica mirrors them into its own
  :class:`SessionStateMixin` machine so the worker's degradation
  policy ages/staleness-caps exactly like the owner's would, and a
  session *re-establishment* replays as ``expire_session`` so the
  worker epoch-flushes its caches like every other full-rebuild path.
- EOF on the fd means the supervisor died: the worker must exit (the
  respawned supervisor has no link to it) via ``on_link_down``.
"""
from __future__ import annotations

import json
import logging
import socket
import time
from typing import Callable, Optional

from binder_torch.introspect.loopacct import ACCOUNT
from binder_torch.shard import protocol
from binder_torch.store.cache import domain_to_path
from binder_torch.store.fake import FakeStore
from binder_torch.store.names import intern_name
from binder_torch.verify.tracer import trace_id


class ShardLinkDown(Exception):
    """The supervisor closed the mutation log (or the stream broke)."""


class ReplicaStore(FakeStore):
    def __init__(self, sock: socket.socket, shard: int,
                 recorder=None,
                 log: Optional[logging.Logger] = None) -> None:
        super().__init__(recorder=recorder)
        self.shard = shard
        self.log = log or logging.getLogger("binder.shard.replica")
        self._sock = sock
        self._rbuf = bytearray()
        self._wbuf = bytearray()
        self._loop = None
        self._writer_armed = False
        self.frames_applied = 0
        self.snapshot_nodes = 0
        # supervisor-reported disconnect age + local receipt instant:
        # disconnected_seconds() keeps aging between heartbeats
        self._sup_disc_s: Optional[float] = None
        self._sup_disc_at = 0.0
        self._sup_est = 0
        # fired (once) when the supervisor link drops; the worker has
        # no way back — its owner and mutation feed are gone
        self.on_link_down: Optional[Callable[[], None]] = None
        self._down = False
        # replica-parity verification: the rolling delta
        # digest — None until snap-end arms it (digests hash only
        # post-snapshot deltas, on both ends) — plus the hooks the
        # worker's verify layer wires up: `tracer` receives each delta
        # frame's trace context, `on_digest(gen, ok, have, want)` the
        # outcome of each digest comparison
        self._dg: Optional[str] = None
        self.tracer = None
        self.on_digest: Optional[Callable] = None

    @classmethod
    def from_fd(cls, fd: int, shard: int, **kw) -> "ReplicaStore":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM,
                             fileno=fd)
        return cls(sock, shard, **kw)

    # -- attach-time snapshot (blocking; runs before the event loop) --

    def read_snapshot(self, timeout: float = 30.0) -> int:
        """Apply frames until ``snap-end``; returns the node count.

        ``timeout`` bounds the time WITHOUT PROGRESS, not the total:
        the supervisor streams large-zone snapshots in bounded chunks
        at the link's pace, so a million-name snapshot legitimately
        takes longer than any fixed total deadline — what signals a
        wedged supervisor is the stream going quiet."""
        self._sock.setblocking(True)
        self._sock.settimeout(timeout)
        deadline = time.monotonic() + timeout
        while True:
            frames = self._recv_frames()
            if frames:
                deadline = time.monotonic() + timeout   # progress
            for k, frame in enumerate(frames):
                if frame.get("op") == "snap-end":
                    self.snapshot_nodes = int(frame.get("nodes", 0))
                    self._sock.settimeout(None)
                    # arm the rolling delta digest: the supervisor
                    # resets its per-link roll at the same stream point
                    self._dg = "0"
                    # frames the same read carried past snap-end open
                    # the delta feed: dropping them would lose those
                    # mutations on this worker for good
                    for later in frames[k + 1:]:
                        self._apply(later)
                    return self.snapshot_nodes
                self._apply(frame)
            if time.monotonic() > deadline:
                raise TimeoutError("shard snapshot stalled for "
                                   f"{timeout}s")

    def _recv_frames(self):
        try:
            chunk = self._sock.recv(1 << 16)
        except socket.timeout:
            raise TimeoutError("shard mutation log stalled mid-snapshot")
        if not chunk:
            raise ShardLinkDown("supervisor closed the mutation log")
        self._rbuf.extend(chunk)
        return protocol.decode_frames(self._rbuf)

    # -- steady state: non-blocking delta feed on the event loop --

    def start(self, loop) -> None:
        self._loop = loop
        self._sock.setblocking(False)
        # one ``feed`` span of loop accounting a read: decode, apply,
        # bump_gen and the synchronous invalidation fan-out; a stall's
        # cause is the propagation trace of the mutation applied last
        loop.add_reader(self._sock.fileno(), ACCOUNT.wrap(
            "feed", self._on_readable,
            cause=lambda: trace_id(self.tracer)))

    def _on_readable(self) -> None:
        try:
            while True:
                chunk = self._sock.recv(1 << 16)
                if not chunk:
                    self._link_down("EOF from supervisor")
                    return
                self._rbuf.extend(chunk)
                if len(chunk) < (1 << 16):
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            self._link_down(f"mutation log read failed: {e}")
            return
        try:
            frames = protocol.decode_frames(self._rbuf)
        except ValueError as e:
            self._link_down(f"corrupt mutation log: {e}")
            return
        for frame in frames:
            try:
                self._apply(frame)
            except Exception:
                # one bad frame must not stop the feed: the mirror
                # self-heals on the next snapshot (respawn) and the
                # failure is loud in the log
                self.log.exception("shard %d: applying frame %r failed",
                                   self.shard, frame.get("op"))

    def _link_down(self, reason: str) -> None:
        if self._down:
            return
        self._down = True
        self.log.error("shard %d: supervisor link down (%s)",
                       self.shard, reason)
        if self._loop is not None:
            try:
                self._loop.remove_reader(self._sock.fileno())
            except (OSError, ValueError):
                pass
        if self.on_link_down is not None:
            self.on_link_down()

    # -- frame application --

    def _apply(self, frame: dict) -> None:
        op = frame.get("op")
        if op in ("node", "gone"):
            if self._dg is not None:
                self._dg = protocol.delta_digest(self._dg, frame)
            tracer = self.tracer
            if tracer is not None and "tr" in frame:
                # stage the owner's trace context: the apply below
                # fires bump_gen on the worker mirror, which consumes
                # it — so the replica-side stages report against the
                # owner's t0
                tracer.inherit(frame.get("tr"), frame.get("t0"))
            if op == "node":
                # intern the frame's domain: delta frames repeat the
                # same hot names endlessly, and the pool makes each ONE
                # object across the protocol, the replica tree, and the
                # mirror
                self._apply_node(intern_name(str(frame["d"])),
                                 frame.get("data"))
            else:
                self.rmr(domain_to_path(str(frame["d"])))
            if tracer is not None:
                tracer.observe("replica-apply")
                tracer.clear()
        elif op == "pnode":
            # raw-path upsert (federation /dcs fanout): applied at the
            # literal path so the worker's DcRegistry watchers fire
            # exactly as they would against a live store.  Outside the
            # replica-parity digest by design (zone data only).
            self._apply_path(str(frame["p"]), frame.get("data"))
        elif op == "pgone":
            self.rmr(str(frame["p"]))
        elif op == "state":
            self._apply_state(frame)
        elif op == "digest":
            self._check_digest(frame)
        else:
            self.log.warning("shard %d: unknown mutation-log op %r",
                             self.shard, op)
            return
        self.frames_applied += 1

    def _check_digest(self, frame: dict) -> None:
        """Compare the owner's rolling digest against ours; report
        mismatches up-channel (replica-digest invariant).  A replica
        that never finished a snapshot (or an older supervisor that
        never sends digests) simply never compares."""
        if self._dg is None:
            return
        want = str(frame.get("dg", ""))
        gen = int(frame.get("gen", 0))
        have = self._dg
        ok = have == want
        if not ok:
            self.log.error(
                "shard %d: replica digest mismatch at gen %d "
                "(have %s want %s)", self.shard, gen, have, want)
            self.send(protocol.digest_report_frame(
                self.shard, gen, False, have, want))
            # resync to the owner's roll: one detected divergence must
            # not cascade into a mismatch per subsequent digest frame
            self._dg = want
        if self.on_digest is not None:
            try:
                self.on_digest(gen, ok, have, want)
            except Exception:  # noqa: BLE001 — observer bug must not
                self.log.exception("on_digest callback failed")

    def _apply_node(self, domain: str, data) -> None:
        self._apply_path(domain_to_path(domain), data)

    def _apply_path(self, path: str, data) -> None:
        raw = b"" if data is None else json.dumps(data).encode("utf-8")
        if self.exists(path):
            self.set_data(path, raw)
        else:
            # mkdirp fires the parent children-watch (creating the
            # worker-mirror TreeNode) and, for non-empty data, the data
            # watch — exactly the event sequence a fresh znode produces
            self.mkdirp(path, raw)

    def _apply_state(self, frame: dict) -> None:
        st = str(frame.get("state", ""))
        est = int(frame.get("est", 0))
        disc = frame.get("disc_s")
        self._sup_disc_s = None if disc is None else float(disc)
        self._sup_disc_at = time.monotonic()
        if st == "connected":
            if self._connected and est != self._sup_est:
                # the OWNER's session cycled while we stayed attached:
                # replay as expiry so the worker's caches epoch-flush
                # like every other full-rebuild path
                self.expire_session()
            elif not self._connected:
                self.start_session()
        elif st in ("degraded", "expired", "closed"):
            if self._connected or self.session_state() != st:
                self._connected = False
                self._session_transition(st, "supervisor " + st)
        self._sup_est = est

    def disconnected_seconds(self):
        """Owner-measured disconnect age (plus the local heartbeat
        gap), so every shard's degradation policy reads the SAME clock
        the supervisor's mirror is actually aging on."""
        if self._session_state == "connected":
            return 0.0
        if self._sup_disc_s is not None:
            return self._sup_disc_s + (time.monotonic()
                                       - self._sup_disc_at)
        return super().disconnected_seconds()

    # -- worker -> supervisor frames --

    def send(self, frame: dict) -> None:
        """Best-effort non-blocking send (hello/stats).  The supervisor
        is a fast local reader; if its end wedges hard enough to fill
        the socketpair, stats frames drop — serving must not block on
        telemetry."""
        if self._down:
            return
        self._wbuf.extend(protocol.encode_frame(frame))
        self._flush()

    def _flush(self) -> None:
        if not self._wbuf:
            return
        try:
            sent = self._sock.send(bytes(self._wbuf))
            del self._wbuf[:sent]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            self._link_down(f"mutation log write failed: {e}")
            return
        if self._wbuf and self._loop is not None \
                and not self._writer_armed:
            self._writer_armed = True
            self._loop.add_writer(self._sock.fileno(), self._on_writable)

    def _on_writable(self) -> None:
        self._loop.remove_writer(self._sock.fileno())
        self._writer_armed = False
        self._flush()

    def close(self) -> None:
        super().close()
        if self._loop is not None:
            try:
                self._loop.remove_reader(self._sock.fileno())
            except (OSError, ValueError):
                pass
            if self._writer_armed:
                try:
                    self._loop.remove_writer(self._sock.fileno())
                except (OSError, ValueError):
                    pass
        try:
            self._sock.close()
        except OSError:
            pass
