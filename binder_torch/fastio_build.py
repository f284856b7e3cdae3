"""Build the port's native code from ``native/`` at first use.

The counterpart of ``native/Makefile``'s rules for the fast-path
extension (``native/fastio/{fastio,fastpath}.c`` into
``_binderfastio<EXT_SUFFIX>``), the ``mbalancer`` binary
(``native/balancer/mbalancer.cpp``) and the ``instance_adjust``
reconciler (``native/adjust/instance_adjust.cpp``), with the same
compilers and flags.  The artifacts go into ``binder_torch/_build/``
(git-ignored), one directory per artifact and cache key; the key
hashes the bytes of every source and header, the command line and the
interpreter's ABI suffix, so a changed source rebuilds and an
unchanged one is found.

Many processes may reach the first use at once (a shard supervisor
and its workers, test workers): the build runs under an ``fcntl``
lock, looks again for the artifact once it holds it, and compiles into
a temporary file that ``os.replace`` moves into place, so a reader
only ever sees a finished artifact.

A failed build raises :class:`NativeBuildError`, which is deliberately
not an ``ImportError``: the serve modules fall back to the Python lane
on ``ImportError`` (as the reference does for an extension that was
never built), and a broken build must stop the process instead.

This module uses only the standard library (shard workers import it
on every start).
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sysconfig
import time
from typing import NamedTuple, Optional, Tuple

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
    art = ARTIFACTS[name]
    out = artifact_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):          # built while we waited
            return out, None
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
    return out, seconds
