"""Bring up and tear down a binder zone topology on the port.

The counterpart of ``bin/binder-topology`` (itself the analog of the
reference's ``boot/setup.sh`` and SMF manifests): N port servers
(``python -m binder_torch.main -b <socket>``) supervised by
``instance_adjust``, fronted by ``mbalancer`` on the public DNS port,
with the metric-ports file re-published on every change.  Both binaries
are the port's own build of ``native/`` (``binder_torch.fastio_build``,
into ``binder_torch/_build/``); a failed build stops ``start``.

    python -m binder_torch.topology start -n <nprocs> -c <config.json>
                    -D <rundir> [-p <port>] [-B <baseport>] [--bind <addr>]
    python -m binder_torch.topology stop   -D <rundir>
    python -m binder_torch.topology status -D <rundir>
    python -m binder_torch.topology metric-ports -D <rundir>

Layout under <rundir>:
    state/     instance_adjust state (props/pid/log per instance)
    sockets/   per-backend balancer sockets + .balancer.stats
    balancer.pid, balancer.port, balancer.log, metric_ports

Instance ``k`` serves on ``<baseport> + k`` and its metrics on that
port + 1000.  ``start`` is idempotent: run again, it restores dead
instances, scales to the new count and leaves a live balancer alone.
"""
import argparse
import os
import select
import shlex
import signal
import subprocess
import sys

from binder_torch import fastio_build

ROOT = os.path.dirname(fastio_build.PACKAGE_DIR)
MAX_INSTANCES = 32  # reference bound (boot/setup.sh:17)
#: how long ``start`` waits for the balancer's ``PORT`` line
BALANCER_ANNOUNCE_S = 30.0


def metric_ports_hook(rundir, baseport, count):
    """Re-publish the metricPorts list: service port + 1000 each
    (reference main.js:144-151 convention)."""
    ports = [baseport + i + 1000 for i in range(count)]
    with open(os.path.join(rundir, "metric_ports"), "w") as f:
        f.write(" ".join(str(p) for p in ports) + "\n")


def cmd_metric_ports(args):
    """Recompute metric_ports from the live socket directory, like the
    reference's metric-ports-updater recomputes metricPorts mdata from
    live instance names (smf/methods/metric-ports-updater.sh:60-83)."""
    rundir = os.path.abspath(args.rundir)
    sockdir = os.path.join(rundir, "sockets")
    ports = sorted(int(name) + 1000 for name in os.listdir(sockdir)
                   if name.isdigit())
    out = os.path.join(rundir, "metric_ports")
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        f.write(" ".join(str(p) for p in ports) + "\n")
    os.replace(tmp, out)
    print(" ".join(str(p) for p in ports))
    return 0


def pid_alive(pidfile):
    """The pid in ``pidfile`` if that process runs (a zombie does not),
    else None."""
    try:
        with open(pidfile) as f:
            pid = int(f.read().strip())
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                return None
        return pid
    except (OSError, ValueError, IndexError):
        return None


def native_binary(name):
    """Path of the port's build of ``name``, built first if need be;
    None (after saying why) when the build fails."""
    try:
        return fastio_build.build(name)[0]
    except fastio_build.NativeBuildError as e:
        print(f"binder-topology: {e}", file=sys.stderr)
        return None


def cmd_start(args):
    rundir = os.path.abspath(args.rundir)
    state = os.path.join(rundir, "state")
    sockets = os.path.join(rundir, "sockets")
    if args.nprocs < 1 or args.nprocs > MAX_INSTANCES:
        print(f"nprocs must be 1..{MAX_INSTANCES}", file=sys.stderr)
        return 1
    # the instances load the extension at start: build it here, once,
    # so a broken build stops this command instead of every instance
    built = []
    for name in ("instance_adjust", "mbalancer", "extension"):
        built.append(native_binary(name))
        if built[-1] is None:
            return 1
    adjust, balancer, _ = built
    os.makedirs(state, exist_ok=True)
    os.makedirs(sockets, exist_ok=True)
    config = os.path.abspath(args.config)

    exec_tmpl = (f"exec {shlex.quote(sys.executable)} -m binder_torch.main "
                 f"-f {shlex.quote(config)} -p %P -b %S")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")

    rc = subprocess.run(
        [adjust, "-s", state, "-b", "binder", "-B", str(args.baseport),
         "-i", str(args.nprocs), "-e", exec_tmpl, "-d", sockets, "-w"],
        env=env).returncode
    if rc != 0:
        print("binder-topology: instance_adjust failed", file=sys.stderr)
        return rc
    metric_ports_hook(rundir, args.baseport, args.nprocs)

    balpid_file = os.path.join(rundir, "balancer.pid")
    if pid_alive(balpid_file) is None:
        log_path = os.path.join(rundir, "balancer.log")
        with open(log_path, "ab") as err:
            proc = subprocess.Popen(
                [balancer, "-d", sockets, "-p", str(args.port),
                 "-b", args.bind, "-s", "1000"],
                stdout=subprocess.PIPE, stderr=err)
        ready, _, _ = select.select([proc.stdout], [], [],
                                    BALANCER_ANNOUNCE_S)
        line = proc.stdout.readline().decode().strip() if ready else ""
        proc.stdout.close()
        if not line.startswith("PORT "):
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            print("binder-topology: balancer failed to start "
                  f"(see {log_path})", file=sys.stderr)
            with open(log_path, errors="replace") as f:
                sys.stderr.write(f.read()[-500:])
            return 1
        with open(balpid_file, "w") as f:
            f.write(str(proc.pid) + "\n")
        with open(os.path.join(rundir, "balancer.port"), "w") as f:
            f.write(line.split()[1] + "\n")
        print(f"balancer up: {line}")
    print(f"topology up: {args.nprocs} instances, "
          f"base port {args.baseport}")
    return 0


def cmd_stop(args):
    rundir = os.path.abspath(args.rundir)
    state = os.path.join(rundir, "state")
    # scale to zero via the reconciler, then stop the balancer
    if os.path.isdir(state):
        adjust = native_binary("instance_adjust")
        if adjust is None:
            return 1
        subprocess.run([adjust, "-s", state, "-b", "binder",
                        "-B", "1", "-i", "0", "-e", "true"])
    balpid = pid_alive(os.path.join(rundir, "balancer.pid"))
    if balpid is not None:
        os.kill(balpid, signal.SIGTERM)
        print(f"balancer {balpid} stopped")
    print("topology down")
    return 0


def cmd_status(args):
    rundir = os.path.abspath(args.rundir)
    state = os.path.join(rundir, "state")
    n = 0
    if os.path.isdir(state):
        for fn in sorted(os.listdir(state)):
            if fn.endswith(".pid"):
                name = fn[:-4]
                pid = pid_alive(os.path.join(state, fn))
                status = f"online (pid {pid})" if pid else "dead"
                print(f"{name}: {status}")
                n += 1
    balpid = pid_alive(os.path.join(rundir, "balancer.pid"))
    print(f"balancer: {'online (pid %d)' % balpid if balpid else 'down'}")
    if not n:
        print("no instances")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="binder-topology")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("start")
    s.add_argument("-n", dest="nprocs", type=int, required=True)
    s.add_argument("-c", dest="config", required=True)
    s.add_argument("-D", dest="rundir", required=True)
    s.add_argument("-p", dest="port", type=int, default=53)
    s.add_argument("-B", dest="baseport", type=int, default=5301)
    s.add_argument("--bind", default="0.0.0.0")
    s.set_defaults(fn=cmd_start)

    s = sub.add_parser("stop")
    s.add_argument("-D", dest="rundir", required=True)
    s.set_defaults(fn=cmd_stop)

    s = sub.add_parser("status")
    s.add_argument("-D", dest="rundir", required=True)
    s.set_defaults(fn=cmd_status)

    s = sub.add_parser("metric-ports")
    s.add_argument("-D", dest="rundir", required=True)
    s.set_defaults(fn=cmd_metric_ports)

    args = ap.parse_args(argv)
    sys.exit(args.fn(args))


if __name__ == "__main__":
    main()
