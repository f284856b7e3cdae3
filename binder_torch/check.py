"""The port's ``make check``: ``python -m binder_torch.check``.

The counterpart of the root ``Makefile``'s ``check`` target, run on
what the port ships: every native build goes through
:mod:`binder_torch.fastio_build` into the git-ignored
``binder_torch/_build/``; ``native/`` and its corpus are only read.
The steps run in order; the first that fails ends the run with exit
code 1 and names what failed, and each step prints its seconds:

a. lint: ``compileall`` over ``binder_torch``, the port's tests and
   ``chip_smoke.py``; ``tools/lint.py binder_torch chip_smoke.py``.
b. werror: the five shipped artifacts built again with ``-Werror``
   (``fastio_build.WERROR``, the root ``Makefile``'s flags and nothing
   else, under the compiler's own defaults) from the sources the port
   builds (``native/`` with ``fastio_build.FIXES``), each into a
   directory of its own: a warning fails the step with the compiler's
   output, and the plain artifacts stay as they are.
c. fuzz: ``native/Makefile``'s ``fuzz-smoke``: the four
   ASan/UBSan-built mutational fuzzers over ``native/fuzz/corpus/<target>``
   at 20,000 iterations, then the four coverage-guided ones at 5,000,
   always with ``FUZZ_COV_NO_SAVE=1`` so the checked-in corpus stays
   byte for byte as it was (the step hashes it before and after).  The
   targets run at once (they only read the corpus).  Each target but
   those of :data:`SILENT` must print its summary with the iterations
   it was asked for; ``fuzz_frames`` and ``fuzz_zlog`` send their
   stderr to ``/dev/null``, so their executions are not measured
   (``None``).  The sanitizers write their reports to files
   (``log_path``, for the same reason); a nonzero exit or a report
   fails the step, and the reports are kept under ``_build/check/``.
d. asan: ``native/Makefile``'s ``check-asan``: the reference's
   fast-path suites (:data:`REFERENCE_SUITES`, unedited) and the port's
   in-process C-lane suites (:data:`PORT_SUITES`) in child ``python -m
   pytest`` processes with ``libasan`` preloaded and
   ``ASAN_OPTIONS=detect_leaks=0``, against ``extension.asan``.  Every
   build is made before the preload is set, so no compiler runs under
   it.  The pytest plugin ``tests/asan_lane.py`` (in the tests tree:
   this module never imports the reference) loads the ASan build before
   collection, as ``binder_tpu._binderfastio`` for the reference's
   suites, and reports what was loaded; the step fails unless every
   ``_binderfastio`` mapped into a suite process is the ASan artifact
   (its bytes, with ``libasan`` among its ``DT_NEEDED``) and every
   suite ran, none skipped.  Scope, as ``check-asan``'s: processes the
   suites start themselves (``LANE_MAIN`` servers, the build tests'
   interpreters) load the plain build under the same preload.

The port suites are those that drive the extension in the pytest
process itself: the C lane against the Python lane and the build
(``test_torch_fastio.py``), the zone table through both packages
(``test_torch_zone.py``), the RRL sampler on the C drain
(``test_torch_rrl_sampling.py``), the native invalidation case
(``test_torch_invalidation.py``) and the query-log ring
(``test_torch_log_ring.py``).  The other suites that load the
extension do so only in servers they start as subprocesses, where the
preload has nothing instrumented to watch.

:func:`run` runs steps in order, stopping at the first failure (this
module's ``main``), or all at once: ``chip_smoke.py``'s ``check`` phase
runs steps (b) to (d) so.
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable

from binder_torch import fastio_build

ROOT = os.path.dirname(fastio_build.PACKAGE_DIR)

#: native/Makefile: FUZZ_SMOKE_ITERS, FUZZ_COV_SMOKE_ITERS
FUZZ_ITERATIONS = 20_000
COV_ITERATIONS = 5_000
#: fuzzers run at once, one a core
FUZZ_JOBS = os.cpu_count() or 1

REFERENCE_SUITES = ("tests/test_fastio.py", "tests/test_fastpath.py",
                    "tests/test_raw_lane.py")
PORT_SUITES = ("tests/test_torch_fastio.py", "tests/test_torch_zone.py",
               "tests/test_torch_rrl_sampling.py",
               "tests/test_torch_invalidation.py",
               "tests/test_torch_log_ring.py")
#: the port's suites run in this many processes, each every N-th test
#: (the build tests of ``test_torch_fastio.py`` take most of the time)
PORT_SHARDS = 6
#: the sanitized pytest processes, run at once: the reference's suites
#: with its module name bound to the ASan build, and the port's
ASAN_RUNS = {
    "reference": (REFERENCE_SUITES, ("--asan-reference",)),
    **{f"port-{i}": (PORT_SUITES, ("--asan-shard", f"{i}/{PORT_SHARDS}"))
       for i in range(PORT_SHARDS)},
}
#: tests/asan_lane.py, with tests/ on PYTHONPATH
ASAN_PLUGIN = "asan_lane"


class CheckFailure(RuntimeError):
    """A step failed; the message names the step and what failed."""


def _log(msg: str) -> None:
    print(f"check: {msg}", flush=True)


#: how much of a sanitizer report a failure quotes (the error and the
#: top of its stack come first)
REPORT_HEAD = 4000


def _tail(text: str, n: int = 3000) -> str:
    return text[-n:].strip()


# -- (a) lint ----------------------------------------------------------


def lint_step() -> dict:
    files = sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    commands = (
        ["-m", "compileall", "-q", "binder_torch", "chip_smoke.py",
         os.path.join("tests", "asan_lane.py")]
        + [os.path.relpath(f, ROOT) for f in files],
        [os.path.join("tools", "lint.py"), "binder_torch", "chip_smoke.py"])
    for cmd in commands:
        proc = subprocess.run([sys.executable, *cmd], cwd=ROOT,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise CheckFailure(f"lint: `{' '.join(cmd)}` exited "
                               f"{proc.returncode}:\n"
                               f"{_tail(proc.stdout + proc.stderr)}")
    return {"lint": proc.stdout.strip()}


# -- (b) -Werror -------------------------------------------------------


def werror_step() -> dict:
    """Build every shipped artifact with ``-Werror``; the compile
    seconds of each (None where it was built already)."""
    try:
        built = fastio_build.build_all(fastio_build.WERROR)
    except fastio_build.NativeBuildError as e:
        raise CheckFailure(f"werror: {e}") from None
    return {"build_s": {name: seconds for name, (_, seconds)
                        in built.items()}}


# -- (c) fuzz smoke ----------------------------------------------------


def corpus_digest(native_dir: str) -> Dict[str, str]:
    """sha256 of every file under ``native/fuzz/corpus``."""
    top = os.path.join(native_dir, "fuzz", "corpus")
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


#: the fuzz targets whose ``fuzz_setup`` points stderr at ``/dev/null``
#: (every mutated input makes the tool under test complain), so they
#: print no summary
SILENT = ("frames", "zlog")
_SUMMARY = re.compile(r": (\d+) (?:iterations|coverage-guided execs) ok "
                      r"\(seed \d+, corpus (\d+)(?:, \+(\d+) new inputs)?")


def _report_dir(prefix: str) -> str:
    """A new directory for sanitizer reports under ``_build/check/``;
    a step that passes removes it."""
    top = os.path.join(fastio_build.BUILD_DIR, "check")
    os.makedirs(top, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=top)


def _reports(report_dir: str, name: str):
    """The sanitizer reports ``log_path=<report_dir>/<name>`` left:
    file names and their text."""
    files = sorted(f for f in os.listdir(report_dir)
                   if f.startswith(name + "."))
    text = ""
    for f in files:
        with open(os.path.join(report_dir, f), errors="replace") as fh:
            text += fh.read()
    return files, text


def _fuzz_one(name: str, corpus: str, iterations: int,
              report_dir: str) -> dict:
    env = dict(os.environ)
    report = os.path.join(report_dir, name)
    for var in ("ASAN_OPTIONS", "UBSAN_OPTIONS"):
        env[var] = ":".join(filter(None, (env.get(var),
                                          f"log_path={report}")))
    if name.endswith("_cov"):
        env["FUZZ_COV_NO_SAVE"] = "1"
    t0 = time.monotonic()
    proc = subprocess.run(
        [fastio_build.artifact_path(name), corpus, str(iterations)],
        env=env, capture_output=True, text=True)
    out = {"seconds": time.monotonic() - t0, "rc": proc.returncode,
           "output": proc.stderr}
    m = _SUMMARY.search(proc.stderr)
    # no summary from SILENT: the corpus is what the engine loads, the
    # executions and new inputs unknown
    out["iterations"] = int(m.group(1)) if m else None
    out["corpus"] = int(m.group(2)) if m else len(
        [f for f in os.listdir(corpus) if not f.startswith(".")])
    out["new_inputs"] = int(m.group(3)) if m and m.group(3) else (
        0 if m else None)
    out["reports"], out["report_text"] = _reports(report_dir, name)
    return out


def fuzz_step(iterations: int = FUZZ_ITERATIONS,
              cov_iterations: int = COV_ITERATIONS) -> dict:
    """Run every fuzzer over its corpus; per fuzzer the iterations it
    reports (those asked for, or the step fails), corpus size, new
    inputs (both None where it prints no summary), seconds and
    sanitizer reports (none, or the step fails)."""
    names = fastio_build.FUZZERS + fastio_build.COV_FUZZERS
    try:
        fastio_build.build_all(names)
    except fastio_build.NativeBuildError as e:
        raise CheckFailure(f"fuzz: {e}") from None
    native = fastio_build.NATIVE_DIR
    before = corpus_digest(native)
    report_dir = _report_dir("fuzz-")
    asked = {name: cov_iterations if name.endswith("_cov") else iterations
             for name in names}
    with ThreadPoolExecutor(FUZZ_JOBS) as pool:
        jobs = {name: pool.submit(
            _fuzz_one, name,
            os.path.join(native, "fuzz", "corpus", name.split("_")[1]),
            asked[name], report_dir) for name in names}
    runs = {name: job.result() for name, job in jobs.items()}
    failed = {name: r for name, r in runs.items()
              if r["rc"] != 0 or r["reports"]}
    if failed:
        raise CheckFailure("fuzz: " + "\n".join(
            f"{name} exited {r['rc']}, reports kept in {report_dir}: "
            f"{r['reports']}\n"
            f"{r['report_text'][:REPORT_HEAD] or _tail(r['output'])}"
            for name, r in failed.items()))
    os.rmdir(report_dir)
    short = {name: r["iterations"] for name, r in runs.items()
             if r["iterations"] != (None if name.split("_")[1] in SILENT
                                    else asked[name])}
    if short:
        raise CheckFailure(f"fuzz: executions reported other than asked "
                           f"for (None: no summary): {short}")
    changed = sorted(set(before.items()) ^ set(corpus_digest(native).items()))
    if changed:
        raise CheckFailure(f"fuzz: the corpus changed: {changed[:5]}")
    for r in runs.values():
        del r["output"], r["rc"], r["report_text"]
        r["reports"] = len(r["reports"])
    return runs


# -- (d) the suites under ASan ----------------------------------------


def needed_libraries(path: str):
    """The ``DT_NEEDED`` entries of an ELF64 little-endian shared
    object."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != b"\x7fELF\x02\x01":
        raise CheckFailure(f"asan: {path} is not an ELF64 LE object")
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", data, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + i * shentsize)
                for i in range(shnum)]
    out = []
    for _, sh_type, _, _, off, size, link, _, _, _ in sections:
        if sh_type != 6:                           # SHT_DYNAMIC
            continue
        stroff = sections[link][4]
        for k in range(0, size, 16):
            tag, val = struct.unpack_from("<qQ", data, off + k)
            if tag == 0:                           # DT_NULL
                break
            if tag == 1:                           # DT_NEEDED
                end = data.index(b"\0", stroff + val)
                out.append(data[stroff + val:end].decode())
    return out


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def libasan() -> str:
    """The ASan runtime the C compiler links (``gcc
    -print-file-name=libasan.so``, as ``native/Makefile`` asks)."""
    out = subprocess.run([fastio_build.CC, "-print-file-name=libasan.so"],
                         capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(out) or not os.path.exists(out):
        raise CheckFailure(f"asan: {fastio_build.CC} has no libasan.so")
    return out


def _junit(path: str, files: Iterable[str]) -> dict:
    suite = ET.parse(path).getroot()
    if suite.tag == "testsuites":
        suite = suite[0]
    counts = {k: int(suite.get(k, 0))
              for k in ("tests", "failures", "errors", "skipped")}
    per_file = {f: 0 for f in files}
    for case in suite.iter("testcase"):
        module = case.get("classname", "").split(".")
        for f in per_file:
            if module[:2] == ["tests", os.path.basename(f)[:-3]]:
                per_file[f] += 1
    counts["passed"] = (counts["tests"] - counts["failures"]
                        - counts["errors"] - counts["skipped"])
    counts["per_file"] = per_file
    return counts


def asan_step(runs=None) -> dict:
    """Run the suites of ``runs`` (default :data:`ASAN_RUNS`) against
    the ASan build; per run its pass count, seconds and the extensions
    it loaded."""
    runs = ASAN_RUNS if runs is None else runs
    try:
        built = fastio_build.build_all(("extension.asan",)
                                       + tuple(fastio_build.ARTIFACTS))
    except fastio_build.NativeBuildError as e:
        raise CheckFailure(f"asan: {e}") from None
    artifact = built["extension.asan"][0]
    if not any(lib.startswith("libasan") for lib in
               needed_libraries(artifact)):
        raise CheckFailure(f"asan: {artifact} does not need libasan")
    digest = _sha256(artifact)
    preload = libasan()
    # reports to files: pytest captures the suites' stderr, and an
    # aborting process never prints what it captured
    report_dir = _report_dir("asan-")
    with tempfile.TemporaryDirectory(prefix="binder_check_") as tmp, \
            ThreadPoolExecutor(len(runs)) as pool:
        jobs = {}
        for name, (files, extra) in runs.items():
            env = dict(os.environ, LD_PRELOAD=preload,
                       ASAN_OPTIONS="detect_leaks=0:log_path="
                       + os.path.join(report_dir, name),
                       PYTHONPATH=os.pathsep.join(filter(None, (
                           os.path.join(ROOT, "tests"),
                           os.environ.get("PYTHONPATH")))))
            # the root named: pytest would take the common ancestor of
            # its path arguments, the build and native directories too
            cmd = [sys.executable, "-m", "pytest", "-q", "--rootdir", ROOT,
                   "-p", "no:cacheprovider", "-p", "no:randomly", "-p",
                   ASAN_PLUGIN, "--asan-native", fastio_build.NATIVE_DIR,
                   "--asan-build", fastio_build.BUILD_DIR, "--asan-report",
                   os.path.join(tmp, name + ".json"), "--junitxml",
                   os.path.join(tmp, name + ".xml"), *extra, *files]
            jobs[name] = pool.submit(_pytest, cmd, env)
        out, errors, ran = {}, [], {}
        for name, job in jobs.items():
            files, extra = runs[name]
            rc, text, seconds = job.result()
            r = out[name] = {"seconds": seconds, "rc": rc}
            xml = os.path.join(tmp, name + ".xml")
            if os.path.exists(xml):
                r.update(_junit(xml, files))
            reference = "--asan-reference" in extra
            for f, n in r.get("per_file", {}).items():
                ran[f] = ran.get(f, 0) + n
            reports, report_text = _reports(report_dir, name)
            if rc != 0 or reports or r.get("skipped") or \
                    not r.get("passed"):
                errors.append(
                    f"{name}: pytest exited {rc}, {r.get('skipped')} "
                    f"skipped, sanitizer reports {reports} (kept in "
                    f"{report_dir}):\n{report_text[:REPORT_HEAD]}\n"
                    f"{_tail(text)}")
                continue
            with open(os.path.join(tmp, name + ".json")) as f:
                loaded = json.load(f)
            r["loaded"] = loaded
            want = "binder_tpu._binderfastio" if reference else \
                "binder_torch._binderfastio"
            plain = [p for p, h in loaded["mapped"].items() if h != digest]
            if want not in loaded["modules"] or not loaded["mapped"] or plain:
                errors.append(f"{name}: not every extension in the process "
                              f"is the ASan build {artifact}: {loaded}")
    idle = [f for f, n in ran.items() if n == 0]
    if idle:
        errors.append(f"suites that ran nothing: {idle}")
    if errors:
        raise CheckFailure("asan: " + "\n".join(errors))
    os.rmdir(report_dir)
    return out


def _pytest(cmd, env):
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.monotonic() - t0


#: every step, in the order ``main`` runs them
STEPS = {"lint": lint_step, "werror": werror_step, "fuzz": fuzz_step,
         "asan": asan_step}


def run(steps, concurrent: bool = False) -> Dict[str, tuple]:
    """Run ``steps`` (name: function), in order until the first that
    fails, or all at once; per step that ran, its result (None if it
    failed), its failure's message (None if it passed) and its
    seconds.  Each step's end and seconds are logged."""
    def timed(name):
        t0 = time.monotonic()
        try:
            out = steps[name](), None
        except CheckFailure as e:
            out = None, str(e)
        seconds = time.monotonic() - t0
        _log(f"{name} {'FAILED' if out[1] else 'ok'} after {seconds:.1f} s")
        return out + (seconds,)

    if concurrent:
        with ThreadPoolExecutor(len(steps)) as pool:
            return dict(zip(steps, pool.map(timed, steps)))
    done = {}
    for name in steps:
        done[name] = timed(name)
        if done[name][1] is not None:
            break
    return done


def main(argv=None) -> int:
    argparse.ArgumentParser(
        prog="python -m binder_torch.check",
        description="the port's make check: lint, -Werror, fuzz smoke, "
                    "the fast-path suites under ASan").parse_args(argv)
    for name, (result, error, seconds) in run(STEPS).items():
        if error is not None:
            print(f"check: FAILED: {error}", file=sys.stderr, flush=True)
            return 1
        _log(json.dumps({"step": name, "seconds": seconds,
                         "result": result}))
    _log("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
