"""Shard mutation-log framing: the supervisor <-> worker wire format.

One UNIX ``socketpair`` per shard carries two ordered streams:

- supervisor -> worker: the **mutation log** — a snapshot of the owner
  mirror (``node`` frames for every mirrored name, bracketed by a
  ``state`` frame and ``snap-end``) followed by an endless delta feed
  (``node`` upserts / ``gone`` removals, emitted from the owner
  MirrorCache's per-name invalidation events) plus periodic session
  ``state`` heartbeats.  Replaying this stream against a fresh
  :class:`~binder_torch.shard.replica.ReplicaStore` reproduces the
  owner's mirror exactly — which is why a respawned shard catches up
  by simply reading from the top (snapshot + replay on attach).
- worker -> supervisor: one ``hello`` after the serve stack is up
  (pid + bound ports), then 1 Hz ``stats`` frames the supervisor folds
  into the aggregated ``binder_shard_*`` metrics and ``/status``.

Framing is 4-byte big-endian length + UTF-8 JSON.  Node data rides as
the owner mirror's *parsed* JSON (re-serialized), not raw znode bytes:
the mirror is the source of truth in shard mode, so every worker
converges to the owner's view even for znodes whose bytes never parsed.
"""
from __future__ import annotations

import hashlib
import json
from typing import List, Optional

#: protocol version, carried in the state frame so a mixed-version
#: supervisor/worker pair fails loudly instead of misapplying frames
SHARD_PROTO_VERSION = 1

#: env var carrying the worker's inherited socketpair fd
SHARD_FD_ENV = "BINDER_SHARD_FD"
#: the supervisor's ``time.monotonic()`` when it spawned the worker: the
#: start of the worker's ``replay`` boot phase
SHARD_SPAWNED_ENV = "BINDER_SHARD_SPAWNED"

#: hard cap on one frame (a 1M-name snapshot ships as many small
#: frames, never one big one; anything larger is a corrupt stream)
MAX_FRAME = 16 << 20


def encode_frame(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise ValueError(f"shard frame over {MAX_FRAME} bytes")
    return len(body).to_bytes(4, "big") + body


def decode_frames(buf: bytearray) -> List[dict]:
    """Consume every complete frame from *buf* (in place); partial
    tails stay buffered for the next read."""
    out: List[dict] = []
    off = 0
    n = len(buf)
    while n - off >= 4:
        ln = int.from_bytes(buf[off:off + 4], "big")
        if ln > MAX_FRAME:
            raise ValueError(f"shard frame length {ln} over cap")
        if n - off - 4 < ln:
            break
        out.append(json.loads(bytes(buf[off + 4:off + 4 + ln])))
        off += 4 + ln
    del buf[:off]
    return out


def node_frame(domain: str, data, tr: Optional[str] = None,
               t0: Optional[float] = None) -> dict:
    """Upsert one mirrored name (data = the mirror's parsed JSON or
    None for a data-less node).  ``tr``/``t0`` optionally carry the
    owner's propagation-trace id and monotonic origin instant
    (CLOCK_MONOTONIC is machine-wide on Linux, so the replica's stage
    timings land on the owner's timeline); older peers ignore them."""
    f = {"op": "node", "d": domain, "data": data}
    if tr is not None:
        f["tr"] = tr
        f["t0"] = t0
    return f


def gone_frame(domain: str, tr: Optional[str] = None,
               t0: Optional[float] = None) -> dict:
    f = {"op": "gone", "d": domain}
    if tr is not None:
        f["tr"] = tr
        f["t0"] = t0
    return f


def path_node_frame(path: str, data) -> dict:
    """Upsert one RAW-PATH node (federation ``/dcs`` fanout): unlike
    ``node`` frames — which are keyed by lookup domain under the served
    zone — these carry subtrees OUTSIDE the zone that
    workers must still track live (DC join/leave).  Applying one at
    the replica fires the same FakeStore watcher events a local store
    mutation would, so the worker's own ``DcRegistry`` sees membership
    changes with zero registry-side changes.  Deliberately NOT part of
    the replica-parity digest: the digest pins zone-data parity, and
    older peers warn-and-ignore the unknown op."""
    return {"op": "pnode", "p": path, "data": data}


def path_gone_frame(path: str) -> dict:
    """Remove one raw-path node (and its subtree) — the ``pnode``
    counterpart for DC leave."""
    return {"op": "pgone", "p": path}


def state_frame(state: str, connected: bool,
                disconnected_s: Optional[float],
                establishments: int) -> dict:
    return {"op": "state", "v": SHARD_PROTO_VERSION, "state": state,
            "connected": connected, "disc_s": disconnected_s,
            "est": establishments}


def snap_end_frame(nodes: int) -> dict:
    return {"op": "snap-end", "nodes": nodes}


def hello_frame(shard: int, pid: int, udp_port: int, tcp_port: int,
                metrics_port: int) -> dict:
    return {"op": "hello", "shard": shard, "pid": pid,
            "udp_port": udp_port, "tcp_port": tcp_port,
            "metrics_port": metrics_port}


def stats_frame(requests: float, gen: int, epoch: int, ready: bool,
                inflight: int, rrl_dropped: int = 0,
                shed: int = 0) -> dict:
    """1 Hz worker report.  ``rrl_dropped`` (response-rate-limit
    drops, monotonic per worker incarnation) folds into
    ``binder_shard_rrl_dropped`` so a flood's per-shard spread is
    scrapeable from the supervisor; older workers simply omit it (the
    default).  ``shed`` stays in the frame for the wire's sake; no
    port worker fills it and no supervisor reads it."""
    return {"op": "stats", "requests": requests, "gen": gen,
            "epoch": epoch, "ready": ready, "inflight": inflight,
            "rrl_dropped": rrl_dropped, "shed": shed}


def delta_digest(prev: str, frame: dict) -> str:
    """Fold one delta frame into the rolling mutation-log digest.

    Both ends of a shard link roll the same function over the same
    ordered ``node``/``gone`` stream, starting from ``"0"`` at
    ``snap-end`` (the stream is ordered, so the reset point aligns
    even when deltas interleave with a snapshot in flight — unhashed
    on both sides).  Only the replicated substance is hashed: op,
    domain, canonicalized data.  Trace fields (``tr``/``t0``) are
    deliberately excluded — they are observability freight, not
    mirrored state, and older peers never see them at all."""
    h = hashlib.sha256()
    h.update(prev.encode("utf-8"))
    h.update(str(frame.get("op")).encode("utf-8"))
    h.update(b"\x00")
    h.update(str(frame.get("d")).encode("utf-8"))
    h.update(b"\x00")
    h.update(json.dumps(frame.get("data"), sort_keys=True,
                        separators=(",", ":")).encode("utf-8"))
    return h.hexdigest()[:16]


def digest_frame(gen: int, digest: str) -> dict:
    """Supervisor -> worker: the owner's rolling digest after the
    delta batch for generation ``gen`` — the replica compares against
    its own roll (cross-shard replica parity); older workers
    warn-and-ignore the unknown op."""
    return {"op": "digest", "gen": gen, "dg": digest}


def digest_report_frame(shard: int, gen: int, ok: bool, have: str,
                        want: str) -> dict:
    """Worker -> supervisor: the outcome of a digest comparison
    (mismatches only — the supervisor counts its own emitted frames as
    checks)."""
    return {"op": "digest-report", "shard": shard, "gen": gen,
            "ok": ok, "have": have, "want": want}


def snapshot_order(domains) -> List[str]:
    """Parents before children (fewer labels first): the replica's
    ``mkdirp`` would create missing parents anyway, but applying in
    tree order means every parent's data lands before its children
    fire the parent's children-watch."""
    return sorted(domains, key=lambda d: (d.count("."), d))
