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

The port builds ``native/`` as it is, with the port's own fixes of
:data:`FIXES` on top: each artifact's sources and headers are copied,
fixed, into a directory beside the artifact that is compiled there and
then removed, so the compiler sees exactly the hashed bytes (a header
missing from an artifact's list fails its build) and ``native/`` is
only read.

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

Beside the five shipped artifacts, :data:`VARIANTS` holds the builds
of the port's ``make check`` (``python -m binder_torch.check``), with
the flags of ``native/Makefile`` and the root ``Makefile``: each
shipped artifact again with ``-Werror`` (``<name>.werror``), the
extension with AddressSanitizer (``extension.asan``), and the
sanitizer-built fuzzers (``fuzz_<target>``, ``fuzz_<target>_cov`` and
the ``covhook`` object the coverage fuzzers link).  A variant is an
artifact of its own name, directory and key, so no variant ever
replaces the plain extension the serve path imports.

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
import shutil
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
    command and what it printed.  ``built``: what the same
    :func:`build_all` call has built, as it would have returned it."""

    built: Dict[str, Tuple[str, Optional[float]]] = {}


class Artifact(NamedTuple):
    output: str                 # file name inside its build directory
    sources: Tuple[str, ...]    # compiled, relative to native/
    headers: Tuple[str, ...]    # hashed only, relative to native/
    cpp: bool
    python: bool                # needs CPython's headers; a shared object
    flags: Optional[Tuple[str, ...]] = None  # None: CFLAGS / CXXFLAGS
    objects: Tuple[str, ...] = ()   # artifacts linked in, built first


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


#: the port's fixes to ``native/``'s sources: per file, ``(text in
#: native/, what the port builds instead)``; each text must occur once
FIXES = {
    # handle_stats ignored write()'s result: a short write cut the
    # reply, and a gcc that defines _FORTIFY_SOURCE on its own (Ubuntu
    # 24.04's at -O2) fails the -Werror build on -Wunused-result
    "balancer/mbalancer.cpp": ((
        "        (void)write(fd, out.data(), out.size());\n",
        "        for (size_t off = 0; off < out.size();) {\n"
        "            ssize_t n = write(fd, out.data() + off,\n"
        "                              out.size() - off);\n"
        "            if (n < 0 && errno == EINTR)\n"
        "                continue;\n"
        "            if (n <= 0)\n"
        "                break;   /* the client is gone or not reading */\n"
        "            off += (size_t)n;\n"
        "        }\n"),),
}


def source_bytes(rel: str) -> bytes:
    """``native/<rel>`` as the port compiles it: with :data:`FIXES`."""
    with open(os.path.join(NATIVE_DIR, rel), "rb") as f:
        data = f.read()
    for old, new in FIXES.get(rel, ()):
        if data.count(old.encode()) != 1:
            raise NativeBuildError(
                f"cannot fix {rel}: {old.strip()!r} is not in it once")
        data = data.replace(old.encode(), new.encode())
    return data


# the root Makefile's `make check`: the native build with -Werror
WERROR_CFLAGS = ("-O2", "-g", "-Wall", "-Wextra", "-Werror")
WERROR_CXXFLAGS = ("-O2", "-g", "-Wall", "-Wextra", "-Werror", "-std=c++17")
# native/Makefile: asan-ext, SANFLAGS (the fuzzers), COVFLAGS
ASAN_CFLAGS = ("-O1", "-g", "-fsanitize=address", "-fno-omit-frame-pointer",
               "-Wall", "-Wextra")
SANFLAGS = ("-O1", "-g", "-fsanitize=address,undefined",
            "-fno-omit-frame-pointer", "-fno-sanitize-recover=all")
FUZZ_CXXFLAGS = SANFLAGS + ("-std=c++17", "-Wall", "-Wextra")
COV_CXXFLAGS = SANFLAGS + ("-fsanitize-coverage=trace-pc", "-std=c++17",
                           "-Wall", "-Wextra")

#: native/Makefile's fuzz targets and the headers each one includes
#: (``fuzz_frames`` and ``fuzz_zlog`` include a whole tool's source)
FUZZ_TARGETS = {
    "dnskey": ("common/dnskey.h",),
    "frames": ("balancer/mbalancer.cpp", "common/dnskey.h"),
    "zlog": ("zklog/zlogcat.cpp",),
    "fastpath": ("fastio/fpcore.h", "common/dnskey.h"),
}


def _variants() -> Dict[str, Artifact]:
    out = {f"{name}.werror": art._replace(
        flags=WERROR_CXXFLAGS if art.cpp else WERROR_CFLAGS)
        for name, art in ARTIFACTS.items()}
    out["extension.asan"] = ARTIFACTS["extension"]._replace(
        flags=ASAN_CFLAGS)
    # compiled without the coverage flag, so it cannot instrument itself
    out["covhook"] = Artifact("covhook.o", ("fuzz/covhook.cpp",), (),
                              cpp=True, python=False,
                              flags=FUZZ_CXXFLAGS + ("-c",))
    for target, headers in FUZZ_TARGETS.items():
        fuzz = Artifact(f"fuzz_{target}", (f"fuzz/fuzz_{target}.cpp",),
                        ("fuzz/fuzz_util.h",) + headers, cpp=True,
                        python=False, flags=FUZZ_CXXFLAGS)
        out[fuzz.output] = fuzz
        out[fuzz.output + "_cov"] = fuzz._replace(
            output=fuzz.output + "_cov", flags=COV_CXXFLAGS,
            objects=("covhook",))
    return out


#: the builds of ``python -m binder_torch.check``; never installed
VARIANTS = _variants()
WERROR = tuple(f"{name}.werror" for name in ARTIFACTS)
FUZZERS = tuple(f"fuzz_{target}" for target in FUZZ_TARGETS)
COV_FUZZERS = tuple(f"{name}_cov" for name in FUZZERS)


def _artifact(name: str) -> Artifact:
    return ARTIFACTS[name] if name in ARTIFACTS else VARIANTS[name]


def _flags(art: Artifact) -> list:
    """The compiler and its flags: everything of the command but the
    output, the sources and the objects."""
    if art.flags is not None:
        flags = [CXX if art.cpp else CC, *art.flags]
    elif art.cpp:
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
        h.update(rel.encode() + b"\0" + source_bytes(rel) + b"\0")
    h.update("\0".join(_flags(art)).encode() + b"\0")
    for obj in art.objects:
        h.update(cache_key(_artifact(obj)).encode() + b"\0")
    h.update(_ext_suffix().encode())
    return h.hexdigest()[:16]


def artifact_path(name: str) -> str:
    """Where ``name``'s artifact lives for the current sources."""
    art = _artifact(name)
    return os.path.join(BUILD_DIR, f"{name}-{cache_key(art)}",
                        art.output)


def build(name: str) -> Tuple[str, Optional[float]]:
    """Path of ``name``'s artifact, built first if need be, and the
    seconds the compiler took (None when it was already built)."""
    return build_all((name,))[name]


def _with_objects(names: Iterable[str]) -> list:
    """``names`` and the artifacts they link in, each object before the
    first artifact that links it."""
    out = []
    for name in names:
        for obj in _with_objects(_artifact(name).objects) + [name]:
            if obj not in out:
                out.append(obj)
    return out


def build_all(names: Iterable[str]) -> Dict[str, Tuple[str,
                                                       Optional[float]]]:
    """:func:`build` for each of ``names`` and of the objects they link
    in, their compilers started together (an artifact's link waits for
    its objects); once every compiler has ended, raises the
    :class:`NativeBuildError` of the first of them that failed (the
    others stay built, and are its ``built``)."""
    outs = {name: artifact_path(name) for name in _with_objects(names)}
    if all(os.path.exists(out) for out in outs.values()):
        return {name: (out, None) for name, out in outs.items()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [name for name, out in outs.items()
                if not os.path.exists(out)]     # else built while we waited
        jobs = {}
        # one thread a compiler, so a link waiting for its objects never
        # holds back a compiler that has not started
        with ThreadPoolExecutor(max(1, len(todo))) as pool:
            for name in todo:
                waits = [jobs[obj] for obj in _artifact(name).objects
                         if obj in jobs]
                jobs[name] = pool.submit(_compile, name, outs[name], waits)
        seconds, failed = {}, []
        for name, job in jobs.items():
            try:
                seconds[name] = job.result()
            except NativeBuildError as e:
                failed.append(e)
        if failed:
            failed[0].built = {name: (out, seconds.get(name))
                               for name, out in outs.items()
                               if os.path.exists(out)}
            raise failed[0]
    return {name: (out, seconds.get(name)) for name, out in outs.items()}


def _compile(name: str, out: str, waits=()) -> float:
    """Compile ``name``'s artifact into ``out`` once the jobs ``waits``
    (its objects) have ended; the compiler's seconds."""
    art = _artifact(name)
    for job in waits:
        job.result()          # an object that failed fails its user too
    tmp = f"{out}.tmp{os.getpid()}"
    src = os.path.join(os.path.dirname(out), f"src.tmp{os.getpid()}")
    cmd = _flags(art) + ["-o", tmp] + [
        os.path.join(src, rel) for rel in art.sources] + [
        artifact_path(obj) for obj in art.objects]
    try:
        for rel in art.sources + art.headers:
            path = os.path.join(src, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(source_bytes(rel))
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=src)
    except OSError as e:
        raise NativeBuildError(
            f"cannot build {art.output}: `{' '.join(cmd)}` did not "
            f"run: {e}") from None
    finally:
        shutil.rmtree(src, ignore_errors=True)
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
