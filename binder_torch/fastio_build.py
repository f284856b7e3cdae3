"""Build the port's native code from ``native/`` at first use.

The counterpart of ``native/Makefile``'s rules for the fast-path
extension (``native/fastio/{fastio,fastpath}.c`` into
``_binderfastio<EXT_SUFFIX>``), the ``mbalancer`` binary
(``native/balancer/mbalancer.cpp``), the ``instance_adjust``
reconciler (``native/adjust/instance_adjust.cpp``), the ``zlogcat``
txnlog decoder (``native/zklog/zlogcat.cpp``) and the ``dnsblast``
load generator (``native/loadgen/dnsblast.cpp``), with the same
compilers and flags.  The artifacts go into ``binder_torch/_build/``
(git-ignored), one directory per artifact and cache key; the key
hashes the bytes of every source and header, the command line and the
interpreter's ABI suffix, so a changed source rebuilds and an
unchanged one is found.

``python -m binder_torch.fastio_build install`` is the port's ``make
-C native``: it builds all five artifacts and points the stable names
``binder_torch/_build/bin/<artifact file>`` at them, so that the
systemd units (``binder_torch/deploy/systemd/``) can name a fixed
path.  A failed build exits 1 with the compiler's error.

Many processes may reach the first use at once (a shard supervisor
and its workers, test workers): the build runs under an ``fcntl``
lock, looks again for the artifacts once it holds it, and compiles
each into a temporary file that ``os.replace`` moves into place, so a
reader only ever sees a finished artifact.  :func:`build_all` starts
the compilers of several artifacts together under that one lock.

A failed build raises :class:`NativeBuildError`, which is deliberately
not an ``ImportError``: the serve modules fall back to the Python lane
on ``ImportError`` (as the reference does for an extension that was
never built), and a broken build must stop the process instead.

This module uses only the standard library (shard workers import it
on every start).
"""
from __future__ import annotations

import argparse
import fcntl
import hashlib
import os
import subprocess
import sys
import sysconfig
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "native")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

CC = "gcc"
CXX = "g++"
# native/Makefile: CFLAGS / CXXFLAGS
CFLAGS = ("-O2", "-g", "-Wall", "-Wextra")
CXXFLAGS = ("-O2", "-g", "-Wall", "-Wextra", "-std=c++17")


class NativeBuildError(RuntimeError):
    """The native code could not be built; the message names the
    command and what it printed."""


class Artifact(NamedTuple):
    output: str                 # file name inside its build directory
    sources: Tuple[str, ...]    # compiled, relative to native/
    headers: Tuple[str, ...]    # hashed only, relative to native/
    cpp: bool
    python: bool                # needs CPython's headers; a shared object


def _ext_suffix() -> str:
    return sysconfig.get_config_var("EXT_SUFFIX") or ".so"


ARTIFACTS = {
    "extension": Artifact(
        "_binderfastio" + _ext_suffix(),
        ("fastio/fastio.c", "fastio/fastpath.c"),
        ("fastio/fastpath.h", "fastio/fpcore.h", "common/dnskey.h"),
        cpp=False, python=True),
    "mbalancer": Artifact(
        "mbalancer", ("balancer/mbalancer.cpp",), ("common/dnskey.h",),
        cpp=True, python=False),
    "instance_adjust": Artifact(
        "instance_adjust", ("adjust/instance_adjust.cpp",), (),
        cpp=True, python=False),
    "zlogcat": Artifact(
        "zlogcat", ("zklog/zlogcat.cpp",), (), cpp=True, python=False),
    "dnsblast": Artifact(
        "dnsblast", ("loadgen/dnsblast.cpp",), (), cpp=True, python=False),
}


def _flags(art: Artifact) -> list:
    """The compiler and its flags: everything of the command but the
    output and the sources."""
    if art.cpp:
        flags = [CXX, *CXXFLAGS]
    else:
        flags = [CC, *CFLAGS]
    if art.python:
        include = sysconfig.get_paths().get("include") or ""
        if not os.path.exists(os.path.join(include, "Python.h")):
            raise NativeBuildError(
                f"cannot build {art.output}: no Python.h in {include!r} "
                "(the interpreter's sysconfig include path)")
        flags += ["-fPIC", "-shared", "-I" + include]
    return flags


def cache_key(art: Artifact) -> str:
    h = hashlib.sha256()
    for rel in art.sources + art.headers:
        with open(os.path.join(NATIVE_DIR, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read() + b"\0")
    h.update("\0".join(_flags(art)).encode() + b"\0")
    h.update(_ext_suffix().encode())
    return h.hexdigest()[:16]


def artifact_path(name: str) -> str:
    """Where ``name``'s artifact lives for the current sources."""
    art = ARTIFACTS[name]
    return os.path.join(BUILD_DIR, f"{name}-{cache_key(art)}",
                        art.output)


def build(name: str) -> Tuple[str, Optional[float]]:
    """Path of ``name``'s artifact, built first if need be, and the
    seconds the compiler took (None when it was already built)."""
    return build_all((name,))[name]


def build_all(names: Iterable[str]) -> Dict[str, Tuple[str,
                                                       Optional[float]]]:
    """:func:`build` for each of ``names``, their compilers started
    together; once every compiler has ended, raises the
    :class:`NativeBuildError` of the first of ``names`` that failed
    (the others stay built)."""
    outs = {name: artifact_path(name) for name in names}
    if all(os.path.exists(out) for out in outs.values()):
        return {name: (out, None) for name, out in outs.items()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [name for name, out in outs.items()
                if not os.path.exists(out)]     # else built while we waited
        with ThreadPoolExecutor(max(1, len(todo))) as pool:
            jobs = {name: pool.submit(_compile, name, outs[name])
                    for name in todo}
        seconds, failed = {}, []
        for name, job in jobs.items():
            try:
                seconds[name] = job.result()
            except NativeBuildError as e:
                failed.append(e)
        if failed:
            raise failed[0]
    return {name: (out, seconds.get(name)) for name, out in outs.items()}


def _compile(name: str, out: str) -> float:
    """Compile ``name``'s artifact into ``out``; the compiler's
    seconds."""
    art = ARTIFACTS[name]
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = _flags(art) + ["-o", tmp] + [
        os.path.join(NATIVE_DIR, src) for src in art.sources]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=NATIVE_DIR)
    except OSError as e:
        raise NativeBuildError(
            f"cannot build {art.output}: `{' '.join(cmd)}` did not "
            f"run: {e}") from None
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise NativeBuildError(
            f"cannot build {art.output}: `{' '.join(cmd)}` exited "
            f"{proc.returncode}:\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return seconds


def bin_path(name: str) -> str:
    """The stable name ``install`` points at ``name``'s artifact."""
    return os.path.join(BUILD_DIR, "bin", ARTIFACTS[name].output)


def install() -> Dict[str, Tuple[str, Optional[float]]]:
    """Build every artifact (:func:`build_all`) and point
    ``_build/bin/<file>`` at each one that built (a relative symlink,
    replaced atomically); returns and raises as :func:`build_all`."""
    try:
        return build_all(ARTIFACTS)
    finally:
        for name in ARTIFACTS:
            path = artifact_path(name)
            if os.path.exists(path):
                link = bin_path(name)
                os.makedirs(os.path.dirname(link), exist_ok=True)
                tmp = f"{link}.tmp{os.getpid()}"
                os.symlink(os.path.relpath(path, os.path.dirname(link)),
                           tmp)
                os.replace(tmp, link)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m binder_torch.fastio_build",
        description="build the port's native artifacts from native/")
    ap.add_argument("command", choices=["install"],
                    help="build all artifacts and link _build/bin/")
    ap.parse_args(argv)
    try:
        built = install()
    except NativeBuildError as e:
        print(f"fastio_build: {e}", file=sys.stderr)
        return 1
    for name, (path, seconds) in built.items():
        how = "cached" if seconds is None else f"built in {seconds!r} s"
        print(f"{bin_path(name)} -> {path} ({how})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
