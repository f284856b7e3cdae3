"""A ``systemctl`` stand-in that runs the port's units.

A test double for ``chip_smoke.py``'s systemd phase and the port's
tests, on hosts where no systemd is booted (a container).  No installed
host uses it: there the units run under systemd itself
(``binder_torch/deploy/README.md``).  ``tests/fake_systemctl.py`` only
keeps state; this one starts the units' real commands, so a converge by
``instance_adjust -m systemd`` boots real servers.

:func:`setup` writes ``<state>/shim.json`` and an executable
``<state>/bin/systemctl``; put ``<state>/bin`` first on ``PATH``.  The
unit directory holds the unit files and their drop-ins (``instance_adjust
-D`` names the same directory, as ``/etc/systemd/system`` is both on a
real host).

Verbs: ``daemon-reload``, ``enable``, ``disable [--now]``, ``start``,
``stop``, ``restart``, ``try-restart`` (unit names or globs),
``reset-failed``, ``show -p ActiveState --value``, ``list-units`` and
``list-unit-files`` (one ``<unit> ...`` row each, as ``instance_adjust``
parses them).

``start`` parses the unit and its drop-ins (``<units>/<unit>.d/*.conf``
in name order), joins ``\\`` continuations, expands ``%i`` and
``${VAR}`` from ``Environment=``, starts the units of ``Requires=`` and
``Wants=`` found in the unit directory first, and honours
``ConditionPathExists=``.  A ``Type=simple`` unit is run by a watcher
process that records the pid, waits for it and records how it ended:
the unit is ``active`` while the pid lives, ``failed``
after it dies on a signal or a non-zero exit, ``inactive`` after
``stop`` (``KillSignal``, then SIGKILL after ``TimeoutStopSec``).  A
``Type=oneshot`` unit runs its ``ExecStart`` lines in order in the
foreground; ``RemainAfterExit=yes`` leaves it ``active``.

The unit runs as written but for these rewrites, each logged to
``<state>/rewrites`` once per unit and command:

- the path prefixes ``/opt/binder`` (the install root) and
  ``/run/binder`` (the run directory) point where :func:`setup` says;
- the balancer's ``-p 53`` becomes a free port;
- ``-b 0.0.0.0`` becomes ``-b 127.0.0.1`` where a socket bound to the
  wildcard answers a loopback client from another address than the
  one it asked (gVisor answers a client at 127.0.1.9 from 127.0.1.9,
  Linux from 127.0.0.1), so that connected client sockets accept the
  balancer's replies; :func:`setup` probes it;
- ``/usr/bin/python3`` becomes the interpreter that ran
  :func:`setup`, where that is another one.

Not applied, and logged as such: ``User=``, ``Group=``,
``AmbientCapabilities=``, ``NoNewPrivileges=`` (the units run as the
caller) and ``Restart=`` (a unit that died stays ``failed`` until
``instance_adjust`` restores it with ``reset-failed`` + ``start``).
``.path`` and ``.target`` units are not run.  Units inherit the
caller's environment (its ``PATH`` leads to this stand-in) plus their
``Environment=``.

Files under ``<state>``: ``log`` (one line per invocation, as
``tests/fake_systemctl.py`` keeps it), ``units/<unit>.json`` (state),
``logs/<unit>.log`` (the unit's output), ``pids`` (``<unit> <pid>
<watcher pid>`` for every process started).

Standard library only: ``instance_adjust`` runs it for every verb.
"""
from __future__ import annotations

import fcntl
import fnmatch
import glob
import json
import os
import re
import shlex
import signal
import subprocess
import sys
import time

STATE = os.environ.get("SYSTEMCTL_SHIM_STATE", "")
#: systemd's DefaultTimeoutStopSec
DEFAULT_STOP_S = 90.0
#: how long ``start`` waits for the watcher to report the pid
SPAWN_WAIT_S = 30.0
IGNORED = ("User", "Group", "AmbientCapabilities", "NoNewPrivileges",
           "Restart", "RestartSec")


def wildcard_answers_from_loopback() -> bool:
    """Whether a UDP socket bound to 0.0.0.0 answers a client at
    127.0.1.9 (which asked 127.0.0.1) from 127.0.0.1."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as srv, \
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as cli:
        srv.bind(("0.0.0.0", 0))
        srv.settimeout(2)
        cli.bind(("127.0.1.9", 0))
        cli.settimeout(2)
        cli.sendto(b"?", ("127.0.0.1", srv.getsockname()[1]))
        data, peer = srv.recvfrom(16)
        srv.sendto(data, peer)
        return cli.recvfrom(16)[1][0] == "127.0.0.1"


def setup(state: str, units: str, root: str, run: str,
          dns_port: int) -> str:
    """Write the stand-in's configuration under ``state`` and return
    the directory to put first on ``PATH``."""
    state = os.path.abspath(state)
    rewrites = [["/opt/binder", os.path.abspath(root)],
                ["/run/binder", os.path.abspath(run)]]
    python = sys.executable
    if os.path.realpath("/usr/bin/python3") != os.path.realpath(python):
        rewrites.append(["/usr/bin/python3", python])
    os.makedirs(os.path.join(state, "bin"), exist_ok=True)
    with open(os.path.join(state, "shim.json"), "w") as f:
        json.dump({"units": os.path.abspath(units), "rewrites": rewrites,
                   "dns_port": int(dns_port), "python": python,
                   "bind": None if wildcard_answers_from_loopback()
                   else "127.0.0.1"}, f)
    wrapper = os.path.join(state, "bin", "systemctl")
    with open(wrapper, "w") as f:
        f.write("#!/bin/sh\n"
                f"SYSTEMCTL_SHIM_STATE={shlex.quote(state)} "
                f"exec {shlex.quote(python)} -E -S "
                f"{shlex.quote(os.path.abspath(__file__))} \"$@\"\n")
    os.chmod(wrapper, 0o755)
    return os.path.dirname(wrapper)


# -- state ----------------------------------------------------------------


def config():
    with open(os.path.join(STATE, "shim.json")) as f:
        return json.load(f)


class Locked:
    """The stand-in's one lock, held around each read-modify-write of
    the state files (the watchers write them too)."""

    def __enter__(self):
        self.f = open(os.path.join(STATE, "lock"), "a")
        fcntl.flock(self.f, fcntl.LOCK_EX)

    def __exit__(self, *exc):
        self.f.close()


def record_path(unit: str) -> str:
    return os.path.join(STATE, "units", unit + ".json")


def read_record(unit: str) -> dict:
    try:
        with open(record_path(unit)) as f:
            return json.load(f)
    except FileNotFoundError:
        return {"state": "inactive", "enabled": False, "pid": None}


def write_record(unit: str, rec: dict) -> None:
    os.makedirs(os.path.join(STATE, "units"), exist_ok=True)
    tmp = record_path(unit) + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, record_path(unit))


def update(unit: str, **fields) -> dict:
    with Locked():
        rec = read_record(unit)
        rec.update(fields)
        write_record(unit, rec)
    return rec


def forget_if_idle(unit: str) -> None:
    """systemd unloads an inactive, disabled unit: it leaves the
    listings (``tests/fake_systemctl.py``'s ``gc_unit``)."""
    with Locked():
        rec = read_record(unit)
        if rec["state"] == "inactive" and not rec["enabled"] and \
                os.path.exists(record_path(unit)):
            os.unlink(record_path(unit))


def alive(pid) -> bool:
    """``pid`` runs and is not a zombie."""
    if not pid:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def active_state(unit: str) -> str:
    rec = read_record(unit)
    if rec["state"] == "active" and rec.get("pid") and \
            not alive(rec["pid"]):
        # died; its watcher is about to record how
        return "deactivating" if alive(rec.get("watcher")) else "failed"
    return rec["state"]


def journal(name: str, line: str) -> None:
    with open(os.path.join(STATE, name), "a") as f:
        f.write(line + "\n")


# -- units ----------------------------------------------------------------


def split_name(unit: str):
    """``binder@5301.service`` -> (``binder@.service``, ``5301``)."""
    m = re.fullmatch(r"([^@]+)@([^.]*)(\.[a-z]+)", unit)
    if m:
        return f"{m.group(1)}@{m.group(3)}", m.group(2)
    return unit, ""


def parse_unit(unit: str):
    """The unit's ``{section: [(key, value), ...]}`` with its drop-ins
    applied, or None when no file defines it."""
    units = config()["units"]
    template, _ = split_name(unit)
    path = os.path.join(units, unit)
    if not os.path.exists(path):
        path = os.path.join(units, template)
    if not os.path.exists(path):
        return None
    files = [path]
    for d in dict.fromkeys((template, unit)):
        files += sorted(glob.glob(os.path.join(units, d + ".d", "*.conf")))
    sections: dict = {}
    for fn in files:
        with open(fn) as f:
            text = re.sub(r"\\\n", " ", f.read())
        section = None
        for line in text.splitlines():
            line = line.strip()
            if not line or line[0] in "#;":
                continue
            if line.startswith("["):
                section = sections.setdefault(line.strip("[]"), [])
            elif "=" in line and section is not None:
                key, value = line.split("=", 1)
                section.append((key.strip(), value.strip()))
    return sections


def values(sections, section: str, key: str):
    return [v for k, v in sections.get(section, []) if k == key]


def last(sections, section: str, key: str, default=None):
    found = values(sections, section, key)
    return found[-1] if found else default


def specifiers(text: str, unit: str) -> str:
    table = {"i": split_name(unit)[1], "%": "%"}
    return re.sub(r"%(.)", lambda m: table.get(m.group(1), m.group(0)),
                  text)


class Rewriter:
    """The stand-in's rewrites of one unit, each logged once."""

    def __init__(self, unit: str):
        cfg = config()
        self.unit, self.pairs = unit, cfg["rewrites"]
        self.dns_port, self.bind = str(cfg["dns_port"]), cfg["bind"]

    def note(self, what: str) -> None:
        line = f"{self.unit}: {what}"
        path = os.path.join(STATE, "rewrites")
        seen = open(path).read().splitlines() if os.path.exists(path) \
            else []
        if line not in seen:
            journal("rewrites", line)

    def path(self, value: str) -> str:
        head = ""
        if "=" in value and not value.startswith("/"):
            head, value = value.split("=", 1)
            head += "="
        for old, new in self.pairs:
            if value == old or value.startswith(old + "/"):
                self.note(f"{old} -> {new}")
                return head + new + value[len(old):]
        return head + value

    def argv(self, argv):
        out = [self.path(a) for a in argv]
        for k in range(1, len(out)):
            if out[k - 1] == "-p" and out[k] == "53":
                self.note(f"-p 53 -> -p {self.dns_port}")
                out[k] = self.dns_port
            elif out[k - 1] == "-b" and out[k] == "0.0.0.0" and self.bind:
                self.note(f"-b 0.0.0.0 -> -b {self.bind}")
                out[k] = self.bind
        return out


def environment(sections, unit: str, rw: Rewriter) -> dict:
    env = dict(os.environ)
    env.pop("SYSTEMCTL_SHIM_STATE", None)
    for value in values(sections, "Service", "Environment"):
        for item in shlex.split(specifiers(value, unit)):
            key, _, val = item.partition("=")
            env[key] = rw.path(val)
    return env


def commands(sections, unit: str, env: dict, rw: Rewriter):
    """Each ``ExecStart``'s argv, ``${VAR}`` expanded in place."""
    return [rw.argv([re.sub(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}",
                            lambda v: env.get(v.group(1), ""), word)
                     for word in shlex.split(specifiers(line, unit))])
            for line in values(sections, "Service", "ExecStart")]


def note_ignored(sections, rw: Rewriter) -> None:
    for key in IGNORED:
        for value in values(sections, "Service", key):
            rw.note(f"not applied: {key}={value}")


def kill_signal(sections) -> int:
    name = last(sections, "Service", "KillSignal", "SIGTERM")
    return int(getattr(signal.Signals, name, signal.SIGTERM))


def stop_timeout(sections) -> float:
    value = last(sections, "Service", "TimeoutStopSec")
    return float(value.rstrip("s")) if value else DEFAULT_STOP_S


# -- verbs ----------------------------------------------------------------


def condition_met(sections, rw: Rewriter) -> bool:
    return all(os.path.exists(rw.path(value)) for value in
               values(sections, "Unit", "ConditionPathExists"))


def start(unit: str, chain=()) -> int:
    if unit in chain:
        return 0
    sections = parse_unit(unit)
    if sections is None:
        print(f"Failed to start {unit}: Unit {unit} not found.",
              file=sys.stderr)
        return 5
    for key in ("Requires", "Wants"):
        for dep in " ".join(values(sections, "Unit", key)).split():
            if parse_unit(dep) is None or active_state(dep) == "active":
                continue
            if start(dep, chain + (unit,)) and key == "Requires":
                update(unit, state="failed", pid=None)
                print(f"A dependency job for {unit} failed.",
                      file=sys.stderr)
                return 1
    state = active_state(unit)
    if state == "active":
        return 0
    if state == "deactivating":
        settle(unit, DEFAULT_STOP_S)
    rw = Rewriter(unit)
    if not condition_met(sections, rw):
        return 0
    note_ignored(sections, rw)
    env = environment(sections, unit, rw)
    workdir = last(sections, "Service", "WorkingDirectory")
    cwd = rw.path(specifiers(workdir, unit)) if workdir else "/"
    cmds = commands(sections, unit, env, rw)
    log_path = os.path.join(STATE, "logs", unit + ".log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    if last(sections, "Service", "Type", "simple") == "oneshot":
        return run_oneshot(unit, sections, cmds, env, cwd, log_path)
    if not cmds:
        print(f"{unit} has no ExecStart", file=sys.stderr)
        return 1
    plan = os.path.join(STATE, "units", unit + ".plan")
    os.makedirs(os.path.dirname(plan), exist_ok=True)
    with open(plan, "w") as f:
        json.dump({"argv": cmds[0], "env": env, "cwd": cwd,
                   "log": log_path}, f)
    update(unit, state="activating", pid=None, stopping=False,
           result=None)
    watcher = subprocess.Popen(
        [sys.executable, "-E", "-S", os.path.abspath(__file__),
         "--watch", unit],
        env=dict(os.environ, SYSTEMCTL_SHIM_STATE=STATE),
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)
    deadline = time.monotonic() + SPAWN_WAIT_S
    while time.monotonic() < deadline:
        rec = read_record(unit)
        if rec["state"] != "activating":
            return 0 if rec["state"] == "active" else 1
        time.sleep(0.01)
    watcher.kill()
    update(unit, state="failed", pid=None)
    return 1


def run_oneshot(unit, sections, cmds, env, cwd, log_path) -> int:
    update(unit, state="activating", pid=None)
    with open(log_path, "ab") as log:
        for argv in cmds:
            try:
                rc = subprocess.run(argv, cwd=cwd, env=env,
                                    stdin=subprocess.DEVNULL, stdout=log,
                                    stderr=subprocess.STDOUT).returncode
            except OSError as e:
                log.write(f"{argv[0]}: {e}\n".encode())
                rc = 203
            if rc:
                update(unit, state="failed", result=f"exit-code {rc}")
                print(f"Job for {unit} failed (exit {rc}); see "
                      f"{log_path}", file=sys.stderr)
                return 1
    remain = last(sections, "Service", "RemainAfterExit", "no")
    update(unit, state="active" if remain in ("yes", "true", "1")
           else "inactive", result="success")
    return 0


def watch(unit: str) -> int:
    """The watcher: run the unit's command, record its pid, wait for
    it and record how it ended."""
    plan = os.path.join(STATE, "units", unit + ".plan")
    with open(plan) as f:
        p = json.load(f)
    with open(p["log"], "ab") as log:
        try:
            child = subprocess.Popen(
                p["argv"], cwd=p["cwd"], env=p["env"],
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT)
        except OSError as e:
            log.write(f"{p['argv'][0]}: {e}\n".encode())
            update(unit, state="failed", pid=None, result="exec")
            return 1
    journal("pids", f"{unit} {child.pid} {os.getpid()}")
    update(unit, state="active", pid=child.pid, watcher=os.getpid())
    code = child.wait()
    with Locked():
        rec = read_record(unit)
        if rec.get("pid") == child.pid:
            if rec.get("stopping"):
                rec["state"] = "inactive"
            else:
                rec["state"] = "failed" if code else "inactive"
            rec.update(pid=None, result=f"exit {code}" if code >= 0
                       else f"signal {-code}")
            write_record(unit, rec)
    return 0


def settle(unit: str, timeout: float) -> bool:
    """Wait until the unit's process is gone and recorded."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rec = read_record(unit)
        if not rec.get("pid") or (not alive(rec["pid"]) and
                                  not alive(rec.get("watcher"))):
            return True
        time.sleep(0.02)
    return False


def stop(unit: str) -> int:
    rec = read_record(unit)
    pid = rec.get("pid")
    if rec["state"] not in ("active", "activating") or not pid:
        if rec["state"] == "active":             # a oneshot kept active
            update(unit, state="inactive")
        return 0
    sections = parse_unit(unit) or {}
    update(unit, stopping=True)
    try:
        os.kill(pid, kill_signal(sections))
    except ProcessLookupError:
        pass
    if not settle(unit, stop_timeout(sections)):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        settle(unit, DEFAULT_STOP_S)
    with Locked():
        rec = read_record(unit)
        rec.update(state="inactive", pid=None, stopping=False)
        write_record(unit, rec)
    return 0


def known_units():
    return sorted(fn[:-len(".json")] for fn in os.listdir(
        os.path.join(STATE, "units")) if fn.endswith(".json")) \
        if os.path.isdir(os.path.join(STATE, "units")) else []


def listing(cmd: str, pattern: str) -> None:
    rows = []
    for unit in known_units():
        if not fnmatch.fnmatch(unit, pattern):
            continue
        state, enabled = active_state(unit), read_record(unit)["enabled"]
        if cmd == "list-units" and state != "inactive":
            sub = {"active": "running", "failed": "failed"}.get(state,
                                                                state)
            rows.append(f"{unit} loaded {state} {sub}")
        elif cmd == "list-unit-files" and enabled:
            rows.append(f"{unit} enabled enabled")
    if rows:
        print("\n".join(rows))


def main(argv) -> int:
    if not STATE:
        print("systemctl stand-in: SYSTEMCTL_SHIM_STATE is not set",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--watch"]:
        return watch(argv[1])
    journal("log", shlex.join(argv))
    if not argv:
        return 1
    cmd, rest = argv[0], argv[1:]
    flags = [a for a in rest if a.startswith("-")]
    args = [a for a in rest if not a.startswith("-")]
    rc = 0
    if cmd == "daemon-reload":
        return 0                 # every start reads the files afresh
    if cmd in ("list-units", "list-unit-files"):
        listing(cmd, args[-1] if args else "*")
        return 0
    if cmd == "show":
        # show -p ActiveState --value <unit>
        print(active_state(args[-1]))
        return 0
    if cmd == "enable":
        for unit in args:
            update(unit, enabled=True)
            if "--now" in flags:
                rc |= start(unit)
        return rc
    if cmd == "disable":
        for unit in args:
            update(unit, enabled=False)
            if "--now" in flags:
                rc |= stop(unit)
            forget_if_idle(unit)
        return rc
    if cmd == "start":
        for unit in args:
            rc |= start(unit)
        return rc
    if cmd == "stop":
        for unit in args:
            rc |= stop(unit)
            forget_if_idle(unit)
        return rc
    if cmd in ("restart", "try-restart"):
        for pattern in args:
            for unit in ([u for u in known_units()
                          if fnmatch.fnmatch(u, pattern)]
                         if cmd == "try-restart" else [pattern]):
                if cmd == "try-restart" and active_state(unit) != "active":
                    continue
                stop(unit)
                rc |= start(unit)
        return rc
    if cmd == "reset-failed":
        for unit in args:
            with Locked():
                rec = read_record(unit)
                if rec["state"] == "failed":
                    rec["state"] = "inactive"
                    write_record(unit, rec)
            forget_if_idle(unit)
        return 0
    print(f"systemctl stand-in: unknown command {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except BrokenPipeError:
        sys.exit(1)
