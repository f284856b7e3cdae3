"""Run a command inside a private network and mount namespace whose
resolver is 127.0.0.1:53, changing nothing on the host.

glibc's stub resolver (``getent``, ``getaddrinfo``, ``gethostbyaddr``,
``res_query`` without a pointed ``_res``) reads ``/etc/resolv.conf``
and asks port 53.  The reference's getent tier rewrites the host's
``/etc/resolv.conf`` as root and binds the host's 127.0.0.1:53
(``tests/test_conformance.py``, ``resolv_override``).  This harness
makes a network and a mount namespace instead
(``unshare --net --mount`` as root, ``unshare --user --map-root-user
--net --mount`` otherwise, mount propagation private) and, inside it,
before it runs the command:

1. brings ``lo`` up (rtnetlink ``RTM_NEWLINK``);
2. puts 192.0.2.1/32 (TEST-NET-1) on ``lo`` (``RTM_NEWADDR``):
   ``getent ahosts*`` asks ``getaddrinfo`` with
   ``AI_ADDRCONFIG``, and glibc counts no loopback address as a
   configured IPv4 address, so without one it answers "not found"
   without sending a query.  Both by rtnetlink, not by ``ioctl``, and
   with no ``lo:1`` label: gVisor, the kernel of the H100 host, answers
   ``SIOCSIFFLAGS`` with ``ENOTTY`` and an ``IFA_LABEL`` attribute with
   ``EOPNOTSUPP``; ``ip(8)`` is not needed;
3. binds a ``resolv.conf`` of ``RESOLV_CONF`` over ``/etc/resolv.conf``,
   or over its target where it is a symlink; where that target is
   missing, binds a private directory holding the file over the
   target's directory, and says so;
4. binds a copy of the host's ``/etc/nsswitch.conf`` whose ``hosts:``
   line is ``hosts: files dns`` over it, so that no ``resolve``,
   ``mdns4_minimal`` or ``myhostname`` module answers;
5. binds an empty directory over ``/run/nscd`` and ``/var/run/nscd``
   where they exist, so that no host ``nscd`` answers over its socket.

A server the command starts on 127.0.0.1:53 lives in the namespace and
goes with it.  Nothing falls back: a step that cannot be made ends the
run with its name and errno, and the command never runs.

Usage: python3 -m binder_torch.cli.resolv_ns [--] COMMAND [ARG...]

The command's standard streams are this process's.  It gets
``RESOLV_NS`` in its environment: one JSON object saying what was made
(``route``, ``address``, ``resolv_conf``, ``nsswitch_hosts``,
``nscd``).

Exit: the command's own status once it ran; 125 when a step failed (the
step and the errno on stderr); 2 on bad arguments.
"""
import ctypes
import errno
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile

RESOLV_CONF = ("nameserver 127.0.0.1\n"
               "options timeout:2 attempts:1 edns0\n")
NSSWITCH_HOSTS = "hosts: files dns"
#: TEST-NET-1 (RFC 5737): an address no real network routes
ADDRESS = "192.0.2.1"
NSCD_DIRS = ("/run/nscd", "/var/run/nscd")
RESOLV_PATH = "/etc/resolv.conf"
NSSWITCH_PATH = "/etc/nsswitch.conf"
#: the exit status of a step that failed (``env`` and ``timeout`` give
#: 125 for their own failures)
SETUP_FAILED = 125

# linux/netlink.h, linux/rtnetlink.h, linux/if.h, linux/fs.h
NLMSG_ERROR = 2
RTM_NEWLINK = 16
RTM_NEWADDR = 20
RTM_DELADDR = 21
NLM_F_REQUEST = 0x1
NLM_F_ACK = 0x4
NLM_F_EXCL = 0x200
NLM_F_CREATE = 0x400
IFA_ADDRESS = 1
IFA_LOCAL = 2
IFF_UP = 0x1
MS_BIND = 4096


class StepError(Exception):
    """A setup step that could not be made, with the errno it met."""

    def __init__(self, step: str, err: int, detail: str = "") -> None:
        super().__init__(step, err, detail)
        self.step, self.err, self.detail = step, err, detail

    def __str__(self) -> str:
        return (f"step {self.step!r} failed: "
                f"{errno.errorcode.get(self.err, self.err)} "
                f"({os.strerror(self.err)})"
                + (f": {self.detail}" if self.detail else ""))


def route() -> str:
    """``root`` where this process may make the namespaces itself,
    ``userns`` where it makes them inside a user namespace."""
    return "root" if os.geteuid() == 0 else "userns"


def unshare_argv(which: str):
    user = ["--user", "--map-root-user"] if which == "userns" else []
    return ["unshare", *user, "--net", "--mount",
            "--propagation", "private", "--"]


def _rtattr(kind: int, data: bytes) -> bytes:
    head = struct.pack("=HH", 4 + len(data), kind) + data
    return head + b"\0" * (-len(head) % 4)


def netlink(step: str, kind: int, flags: int, body: bytes) -> None:
    """Send one rtnetlink request and raise ``StepError`` unless the
    kernel acknowledges it."""
    msg = struct.pack("=LHHLL", 16 + len(body), kind,
                      NLM_F_REQUEST | NLM_F_ACK | flags, 1, 0) + body
    try:
        with socket.socket(socket.AF_NETLINK, socket.SOCK_RAW,
                           socket.NETLINK_ROUTE) as s:
            s.settimeout(5.0)
            s.sendall(msg)
            reply = s.recv(65536)
    except OSError as e:
        raise StepError(step, e.errno or errno.EIO, "rtnetlink") from None
    _, rtype = struct.unpack_from("=LH", reply)
    err = -struct.unpack_from("=i", reply, 16)[0] \
        if rtype == NLMSG_ERROR else errno.EPROTO
    if err:
        raise StepError(step, err, f"rtnetlink message {kind}")


def loopback_up() -> None:
    """``RTM_NEWLINK`` with ``IFF_UP`` on ``lo``."""
    step = "loopback up"
    try:
        index = socket.if_nametoindex("lo")
    except OSError as e:
        raise StepError(step, e.errno or errno.ENODEV, "lo") from None
    netlink(step, RTM_NEWLINK, 0,
            struct.pack("=BxHiII", socket.AF_UNSPEC, 0, index, IFF_UP,
                        IFF_UP))


def set_address(on: bool = True) -> None:
    """Add (or, ``on=False``, delete) ``ADDRESS``/32 on ``lo``."""
    step = f"address {ADDRESS}/32 on lo"
    packed = socket.inet_aton(ADDRESS)
    body = (struct.pack("=BBBBI", socket.AF_INET, 32, 0, 0,
                        socket.if_nametoindex("lo"))
            + _rtattr(IFA_LOCAL, packed) + _rtattr(IFA_ADDRESS, packed))
    if on:
        netlink(step, RTM_NEWADDR, NLM_F_CREATE | NLM_F_EXCL, body)
    else:
        netlink(step, RTM_DELADDR, 0, body)


def configure_network() -> None:
    """``lo`` up, then ``ADDRESS``/32 on it."""
    loopback_up()
    set_address()


def _libc():
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mount.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                           ctypes.c_char_p, ctypes.c_ulong,
                           ctypes.c_void_p]
    libc.mount.restype = ctypes.c_int
    return libc


def bind(libc, source: str, target: str, step: str) -> None:
    if libc.mount(source.encode(), target.encode(), None, MS_BIND,
                  None) != 0:
        raise StepError(step, ctypes.get_errno(),
                        f"bind {source} on {target}")


def check_private() -> None:
    """Fail unless every mount here is private, so that no bind below
    can reach the host's mount namespace."""
    with open("/proc/self/mountinfo") as f:
        for line in f:
            optional = line.split(" - ", 1)[0].split()[6:]
            if any(o.startswith("shared:") for o in optional):
                raise StepError("private mounts", errno.EPERM,
                                "a shared mount: "
                                + " ".join(line.split()[3:5]))


def _is_hosts(line: str) -> bool:
    return ":" in line and line.split(":", 1)[0].strip() == "hosts"


def nsswitch_text(host: str) -> str:
    """The host's ``nsswitch.conf`` with its ``hosts:`` line, or a new
    one, set to ``NSSWITCH_HOSTS``."""
    lines = [NSSWITCH_HOSTS if _is_hosts(ln) else ln
             for ln in host.splitlines()]
    if NSSWITCH_HOSTS not in lines:
        lines.append(NSSWITCH_HOSTS)
    return "\n".join(lines) + "\n"


def hosts_line(text: str) -> str:
    """The ``hosts:`` line of an ``nsswitch.conf``, blanks squeezed."""
    return next((" ".join(ln.split()) for ln in text.splitlines()
                 if _is_hosts(ln)), "")


def configure_files(stage: str) -> dict:
    """The binds of steps 3-5, from files written under ``stage``."""
    libc = _libc()
    check_private()
    report = {}
    conf = os.path.join(stage, "resolv.conf")
    with open(conf, "w") as f:
        f.write(RESOLV_CONF)
    target = os.path.realpath(RESOLV_PATH)
    if os.path.isfile(target):
        bind(libc, conf, target, "resolv.conf")
        report["resolv_conf"] = target
    else:
        # a dangling link (a resolver service that is not running):
        # give the target's directory a private stand-in holding it
        parent = os.path.dirname(target)
        if not os.path.isdir(parent):
            raise StepError("resolv.conf", errno.ENOENT,
                            f"{RESOLV_PATH} -> {target}, and {parent} "
                            "is missing")
        held = os.path.join(stage, "resolv-dir")
        os.mkdir(held)
        os.rename(conf, os.path.join(held, os.path.basename(target)))
        bind(libc, held, parent, "resolv.conf")
        report["resolv_conf"] = (f"{target} was missing: a private "
                                 f"{parent} holds it")
    try:
        with open(NSSWITCH_PATH) as f:
            host = f.read()
    except OSError as e:
        raise StepError("nsswitch.conf", e.errno, NSSWITCH_PATH) from None
    nss = os.path.join(stage, "nsswitch.conf")
    with open(nss, "w") as f:
        f.write(nsswitch_text(host))
    bind(libc, nss, os.path.realpath(NSSWITCH_PATH), "nsswitch.conf")
    report["nsswitch_hosts"] = {"host": hosts_line(host),
                                "here": NSSWITCH_HOSTS}
    empty = os.path.join(stage, "nscd")
    os.mkdir(empty)
    covered = []
    for d in dict.fromkeys(os.path.realpath(p) for p in NSCD_DIRS):
        if os.path.isdir(d):
            bind(libc, empty, d, "nscd")
            covered.append(d)
    report["nscd"] = covered
    return report


def inner(ready_fd: int, which: str, stage: str, argv) -> int:
    """In the namespace: make every step from files written under
    ``stage``, tell the parent on ``ready_fd``, then become the
    command."""
    try:
        configure_network()
        report = {"route": which, "address": f"{ADDRESS}/32 on lo",
                  **configure_files(stage)}
    except StepError as e:
        print(f"resolv_ns: {e}", file=sys.stderr)
        return SETUP_FAILED
    env = dict(os.environ, RESOLV_NS=json.dumps(report))
    os.write(ready_fd, b"1")
    os.close(ready_fd)
    try:
        os.execvpe(argv[0], argv, env)
    except OSError as e:
        print(f"resolv_ns: {argv[0]}: {e}", file=sys.stderr)
        return 127


def run(argv) -> int:
    """Make the namespace, run ``argv`` in it, return its status."""
    which = route()
    # the binds read these files for as long as the namespace lives
    # (gVisor drops a bind whose source is unlinked), so they go only
    # once the command has exited
    stage = tempfile.mkdtemp(prefix="resolv_ns_")
    r, w = os.pipe()
    cmd = [*unshare_argv(which), sys.executable, os.path.abspath(__file__),
           "--inner", str(w), which, stage, "--", *argv]
    try:
        try:
            proc = subprocess.Popen(cmd, pass_fds=(w,))
        except OSError as e:
            print(f"resolv_ns: {StepError('unshare', e.errno, cmd[0])}",
                  file=sys.stderr)
            return SETUP_FAILED
        finally:
            os.close(w)

        def forward(signum, _frame):
            proc.send_signal(signum)

        old = {s: signal.signal(s, forward)
               for s in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)}
        try:
            rc = proc.wait()
        finally:
            for s, h in old.items():
                signal.signal(s, h)
    finally:
        with os.fdopen(r, "rb") as f:
            ready = f.read()
        shutil.rmtree(stage)
    if ready or rc == SETUP_FAILED:
        return rc
    print(f"resolv_ns: step 'unshare' failed: "
          f"{' '.join(cmd[:-len(argv)])} exited {rc} before the "
          "namespace was made", file=sys.stderr)
    return SETUP_FAILED


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["--inner"] and len(args) >= 6 and args[4] == "--":
        return inner(int(args[1]), args[2], args[3], args[5:])
    if args[:1] == ["--"]:
        args = args[1:]
    if not args or args[0].startswith("-"):
        print(__doc__.split("Usage: ", 1)[1].split("\n\n", 1)[0],
              file=sys.stderr)
        return 2
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
