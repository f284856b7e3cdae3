"""The port's ``make check`` (``python -m binder_torch.check``) on the CPU.

Each step of the check at small counts: the fuzz smoke at 200
mutational and 50 coverage-guided iterations a target, with every file
of ``native/fuzz/corpus/`` hashed before and after; the ``-Werror``
build, whose variants have keys of their own and leave the plain
extension's path and bytes as they were, and which holds on a
toolchain that defines ``_FORTIFY_SOURCE`` on its own only through the
port's fix of ``mbalancer.cpp`` (``fastio_build.FIXES``; the reference's
line fails there, ROADMAP §C, fault 9); the port's counterparts of the
reference's ``test_fastio.py`` and ``test_raw_lane.py`` in child
pytests with ``libasan`` preloaded against the port's ASan build, the
``reference`` cases deselected and no ``binder_tpu`` module loaded, and
the step failing where a suite process loads one.  Then each step against a copy of ``native/``
(``fastio_build.NATIVE_DIR`` pointed at it) with a planted defect: an
unused variable fails the ``-Werror`` step, a one-byte read past a
heap block in ``fastpath.c`` fails the ASan step, a planted crash or
a fuzzer that stops short fails the fuzz step.  The smoke's ``check``
phase runs the same functions at ``native/Makefile``'s counts on the
GPU host; here at small counts, and with a planted warning, which
fails the phase after the other steps have run and been printed.

The module first builds every artifact one compiler at a time, and
runs two fuzzers at a time: the steps start their compilers and
fuzzers together, which would take every core from the timing-bound
tests that run beside these.
"""
import hashlib
import json
import os
import shutil
import subprocess

import pytest

from binder_torch import check, fastio_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built_one_at_a_time():
    names = tuple(fastio_build.ARTIFACTS) + tuple(fastio_build.VARIANTS)
    for name in fastio_build._with_objects(names):
        try:
            fastio_build.build(name)
        except fastio_build.NativeBuildError:
            pass        # the test that needs it fails or skips on its own


@pytest.fixture(autouse=True)
def two_fuzzers_at_a_time(monkeypatch):
    monkeypatch.setattr(check, "FUZZ_JOBS", 2)


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def corpus_files():
    top = os.path.join(ROOT, "native", "fuzz", "corpus")
    return {os.path.relpath(os.path.join(d, f), top):
            sha256(os.path.join(d, f))
            for d, _, files in os.walk(top) for f in files}


@pytest.fixture
def sanitizers(tmp_path):
    """Skip where the compiler cannot build and run an ASan/UBSan
    program."""
    src = tmp_path / "probe.cpp"
    src.write_text("int main() { return 0; }\n")
    probe = subprocess.run(
        [fastio_build.CXX, *fastio_build.SANFLAGS, "-o",
         str(tmp_path / "probe"), str(src)], capture_output=True)
    if probe.returncode != 0 or subprocess.run(
            [str(tmp_path / "probe")]).returncode != 0:
        pytest.skip(f"{fastio_build.CXX} cannot build with "
                    f"{' '.join(fastio_build.SANFLAGS)}")
    try:
        check.libasan()
    except check.CheckFailure as e:
        pytest.skip(str(e))


def own_build_dir(tmp_path, monkeypatch):
    """Point the build at a directory of the test's own that links to
    every artifact built so far: a key hashes the sources and flags,
    so only what the test changes is compiled again, and nothing it
    builds lands beside the shipped artifacts."""
    build = tmp_path / "build"
    build.mkdir()
    real = fastio_build.BUILD_DIR
    for d in os.listdir(real) if os.path.isdir(real) else ():
        if "-" in d and os.path.isdir(os.path.join(real, d)):
            os.symlink(os.path.join(real, d), build / d)
    monkeypatch.setattr(fastio_build, "BUILD_DIR", str(build))


def planted(tmp_path, monkeypatch, rel, old, new):
    """Point the build at a copy of ``native/`` whose ``rel`` has
    ``old`` replaced by ``new``, and at a build directory of the
    test's own."""
    native = tmp_path / "native"
    shutil.copytree(os.path.join(ROOT, "native"), native,
                    ignore=shutil.ignore_patterns("build"))
    text = (native / rel).read_text()
    assert old in text
    (native / rel).write_text(text.replace(old, new, 1))
    monkeypatch.setattr(fastio_build, "NATIVE_DIR", str(native))
    own_build_dir(tmp_path, monkeypatch)
    return native


def toolchain_fortify(monkeypatch):
    """``mbalancer``'s ``-Werror`` build as under a gcc that defines
    ``_FORTIFY_SOURCE`` on its own (Ubuntu 24.04's at -O2)."""
    art = fastio_build.VARIANTS["mbalancer.werror"]
    monkeypatch.setitem(fastio_build.VARIANTS, "mbalancer.werror",
                        art._replace(flags=art.flags
                                     + ("-D_FORTIFY_SOURCE=3",)))


# -- the steps --------------------------------------------------------


def test_fuzz_step_leaves_the_corpus_as_it_was(sanitizers):
    before = corpus_files()
    runs = check.fuzz_step(iterations=200, cov_iterations=50)
    assert set(runs) == set(fastio_build.FUZZERS + fastio_build.COV_FUZZERS)
    for name, r in runs.items():
        assert r["reports"] == 0, name
        target = name.split("_")[1]
        # the executions each target reports; those that keep their
        # stderr print a summary, the others are not measured
        assert r["iterations"] == (
            None if target in check.SILENT
            else 50 if name.endswith("_cov") else 200), name
        assert r["corpus"] >= len(os.listdir(os.path.join(
            ROOT, "native", "fuzz", "corpus", target))), name
    assert runs["fuzz_dnskey"]["new_inputs"] == 0
    assert runs["fuzz_fastpath_cov"]["new_inputs"] is not None
    assert corpus_files() == before


def test_variant_keys_are_their_own():
    plain = {name: fastio_build.cache_key(art)
             for name, art in fastio_build.ARTIFACTS.items()}
    for name, art in fastio_build.VARIANTS.items():
        key = fastio_build.cache_key(art)
        assert key not in plain.values(), name
        assert fastio_build.artifact_path(name) not in {
            fastio_build.artifact_path(p) for p in plain}
    assert set(fastio_build.WERROR) == {f"{n}.werror" for n in plain}
    asan = fastio_build.VARIANTS["extension.asan"]
    assert asan.output == fastio_build.ARTIFACTS["extension"].output
    assert "-fsanitize=address" in fastio_build._flags(asan)
    # the coverage hook is compiled without the coverage flag, and each
    # coverage fuzzer's key follows it
    hook = fastio_build.VARIANTS["covhook"]
    assert not any("coverage" in f for f in hook.flags)
    for name in fastio_build.COV_FUZZERS:
        art = fastio_build.VARIANTS[name]
        assert art.objects == ("covhook",)
        assert "-fsanitize-coverage=trace-pc" in art.flags
        assert fastio_build.cache_key(art) != fastio_build.cache_key(
            art._replace(objects=()))


def test_werror_step_keeps_the_plain_build_and_holds_under_fortify(
        tmp_path, monkeypatch):
    path = fastio_build.build("extension")[0]
    digest = sha256(path)
    built = check.werror_step()
    assert set(built) == {"build_s"}
    assert set(built["build_s"]) == set(fastio_build.WERROR)
    assert fastio_build.artifact_path("extension") == path
    assert sha256(path) == digest
    for name in fastio_build.WERROR:
        flags = fastio_build._flags(fastio_build.VARIANTS[name])
        assert "-Werror" in flags and not any(
            "FORTIFY" in f for f in flags), name
        assert os.path.exists(fastio_build.artifact_path(name))
    # a gcc that defines _FORTIFY_SOURCE on its own: the port's fixed
    # mbalancer.cpp builds clean ...
    own_build_dir(tmp_path, monkeypatch)
    toolchain_fortify(monkeypatch)
    assert check.werror_step()["build_s"]["mbalancer.werror"] is not None
    # ... and the reference's line fails the gate (ROADMAP §C, fault 9)
    monkeypatch.setattr(fastio_build, "FIXES", {})
    with pytest.raises(check.CheckFailure) as err:
        check.werror_step()
    said = str(err.value)
    assert said.startswith("werror: cannot build mbalancer")
    assert "mbalancer.cpp:1655" in said and "unused-result" in said
    assert sha256(path) == digest


def test_port_fixes_are_what_the_compiler_sees(tmp_path, monkeypatch):
    # every fix applies to native/ once and is what the build hashes;
    # native/ itself is only read (the fortify case above shows the
    # compiler sees the fix)
    for rel, fixes in fastio_build.FIXES.items():
        with open(os.path.join(ROOT, "native", rel), "rb") as f:
            data = f.read()
        fixed = fastio_build.source_bytes(rel)
        for old, new in fixes:
            assert data.count(old.encode()) == 1, rel
            assert old.encode() not in fixed and new.encode() in fixed
    # the compiler reads a copy, gone once the artifact is built
    path = fastio_build.build("mbalancer")[0]
    assert os.listdir(os.path.dirname(path)) == ["mbalancer"]
    fixed_key = fastio_build.cache_key(fastio_build.ARTIFACTS["mbalancer"])
    monkeypatch.setattr(fastio_build, "FIXES", {})
    assert fastio_build.cache_key(
        fastio_build.ARTIFACTS["mbalancer"]) != fixed_key
    # a native/ the fix no longer matches fails the build, never
    # compiles the source unfixed
    monkeypatch.undo()
    (old, _), = fastio_build.FIXES["balancer/mbalancer.cpp"]
    planted(tmp_path, monkeypatch, "balancer/mbalancer.cpp", old,
            old.replace("(void)write", "(void)!write"))
    with pytest.raises(fastio_build.NativeBuildError) as err:
        fastio_build.build("mbalancer")
    assert "cannot fix balancer/mbalancer.cpp" in str(err.value)


def test_asan_step_runs_the_reference_suite(sanitizers):
    # the reference's test_fastio.py and test_raw_lane.py suites, run as
    # their port counterparts (TestBatchIO, test_torch_raw_lane.py) on
    # the ASan build: the step no longer loads the reference itself.
    # The raw lane's parity case with the reference is deselected
    runs = {"port-0": (("tests/test_torch_fastio.py",), ("-k",
                                                         "TestBatchIO")),
            "port-1": (("tests/test_torch_raw_lane.py",), ())}
    out = check.asan_step(runs)
    fastio_run = out["runs"]["port-0"]
    assert fastio_run["passed"] == fastio_run["tests"] == 7
    assert fastio_run["skipped"] == 0
    assert out["runs"]["port-1"]["passed"] == 13
    assert out["passed"] == 20
    assert out["counterparts"] == {"tests/test_fastio.py": 7,
                                   "tests/test_fastpath.py": 0,
                                   "tests/test_raw_lane.py": 13}
    assert out["deselected_reference"] == 1
    assert out["reference_modules"] == []
    asan = fastio_build.artifact_path("extension.asan")
    assert any(lib.startswith("libasan")
               for lib in check.needed_libraries(asan))
    assert not any(lib.startswith("libasan") for lib in
                   check.needed_libraries(fastio_build.build("extension")[0]))
    for run in out["runs"].values():
        assert set(run["loaded"]["mapped"].values()) == {sha256(asan)}
        assert list(run["loaded"]["modules"]) == [
            "binder_torch._binderfastio"]


def test_asan_step_fails_where_the_reference_loads(sanitizers, tmp_path):
    # a sanitized case that imports binder_tpu without the marker
    planted = tmp_path / "test_planted_reference.py"
    planted.write_text("def test_planted():\n"
                       "    import binder_tpu.dns.wire\n")
    runs = {"port-0": (("tests/test_torch_fastio.py", str(planted)),
                       ("-k", "TestBatchIO or planted"))}
    with pytest.raises(check.CheckFailure) as err:
        check.asan_step(runs)
    said = str(err.value)
    assert "port-0: the reference was loaded: ['binder_tpu'" in said
    assert "binder_tpu.dns.wire" in said


# -- planted defects --------------------------------------------------


def test_werror_step_fails_on_an_unused_variable(tmp_path, monkeypatch):
    planted(tmp_path, monkeypatch, "loadgen/dnsblast.cpp",
            "int main(", "int planted() { int unused_planted = 1; "
            "return 0; }\n\nint main(")
    plain = fastio_build.build("dnsblast")[0]      # warns, builds
    assert os.path.exists(plain)
    with pytest.raises(check.CheckFailure) as err:
        check.werror_step()
    said = str(err.value)
    assert said.startswith("werror: cannot build dnsblast")
    assert "unused_planted" in said and "-Werror" in said


def test_asan_step_fails_on_a_read_past_a_heap_block(
        sanitizers, tmp_path, monkeypatch):
    planted(tmp_path, monkeypatch, "fastio/fastpath.c",
            "    fp_cache_t *c = calloc(1, sizeof(*c));\n"
            "    if (c == NULL)\n"
            "        return PyErr_NoMemory();\n",
            "    fp_cache_t *c = calloc(1, sizeof(*c));\n"
            "    if (c == NULL)\n"
            "        return PyErr_NoMemory();\n"
            "    volatile char planted = ((const char *)c)[sizeof(*c)];\n"
            "    (void)planted;\n")
    runs = {"port-0": (("tests/test_torch_fastpath.py",),
                       ("-k", "TestFastpathUnit"))}
    with pytest.raises(check.CheckFailure) as err:
        check.asan_step(runs)
    said = str(err.value)
    assert "ERROR: AddressSanitizer" in said
    assert "heap-buffer-overflow" in said and "fastpath_new" in said


def test_fuzz_step_fails_on_a_planted_crash(
        sanitizers, tmp_path, monkeypatch):
    planted(tmp_path, monkeypatch, "fuzz/fuzz_dnskey.cpp",
            "void fuzz_one(const uint8_t *data, size_t len) {",
            "void fuzz_one(const uint8_t *data, size_t len) {\n"
            "    if (len > 0) {\n"
            "        volatile int *planted = nullptr;\n"
            "        *planted = 1;\n"
            "    }")
    with pytest.raises(check.CheckFailure) as err:
        check.fuzz_step(iterations=200, cov_iterations=50)
    said = str(err.value)
    assert said.startswith("fuzz: fuzz_dnskey exited")
    assert "fuzz_dnskey_cov exited" in said
    assert "runtime error: store to null pointer" in said
    assert "fuzz_frames" not in said


def test_fuzz_step_fails_on_a_fuzzer_that_stops_short(
        sanitizers, tmp_path, monkeypatch):
    planted(tmp_path, monkeypatch, "fuzz/fuzz_dnskey.cpp",
            "int main(int argc, char **argv) {",
            "int main(int argc, char **argv) {\n"
            "    if (argc > 2)\n"
            "        argv[2] = (char *)\"100\";")
    with pytest.raises(check.CheckFailure) as err:
        check.fuzz_step(iterations=200, cov_iterations=50)
    said = str(err.value)
    assert said.startswith("fuzz: executions reported other than asked")
    assert "'fuzz_dnskey': 100" in said
    assert "'fuzz_dnskey_cov': 100" in said
    assert "fuzz_fastpath" not in said and "fuzz_frames" not in said


# -- the smoke's check phase -------------------------------------------


def test_chip_smoke_check_phase_on_the_cpu(sanitizers):
    # the phase's three steps at once, at small counts and two suites;
    # the report carries what the smoke's ``check`` line prints
    import chip_smoke
    built = chip_smoke.native_phase(hosts=200, also=chip_smoke.check_builds())
    runs = {"port-0": (("tests/test_torch_fastio.py",), ("-k",
                                                         "TestBatchIO")),
            "port-1": (("tests/test_torch_rrl_sampling.py",), ())}
    report = chip_smoke.make_check_phase(built["also_build_s"], (200, 50),
                                         runs)
    assert set(report["seconds"]) == {"werror", "fuzz", "asan"}
    assert set(report["build_s"]) == set(chip_smoke.check_builds()) - {
        "extension", "mbalancer", "instance_adjust"} | {"covhook"}
    assert report["asan"]["passed"] == 10
    assert report["asan"]["counterparts"]["tests/test_fastio.py"] == 7
    assert report["asan"]["reference_modules"] == []
    assert report["asan"]["runs"]["port-1"]["loaded"] == [
        "binder_torch._binderfastio"]
    assert all(r["reports"] == 0 for r in report["fuzz"].values())
    assert report["failed"] == []


def test_chip_smoke_check_phase_fails_after_every_step_ran(
        sanitizers, tmp_path, monkeypatch, capsys):
    # a warning in a shipped artifact: the native phase still builds
    # its own three and the rest; the check phase runs all three steps,
    # prints its line, then fails on the warning
    import chip_smoke
    # planted through the flags: the native phase imports the extension
    # from the build directory, so it stays the real one
    plant = tmp_path / "planted.h"
    plant.write_text("static int planted() { int unused_planted = 1; "
                     "return 0; }\n")
    art = fastio_build.VARIANTS["dnsblast.werror"]
    monkeypatch.setitem(fastio_build.VARIANTS, "dnsblast.werror",
                        art._replace(flags=art.flags
                                     + ("-include", str(plant))))
    failed = os.path.dirname(fastio_build.artifact_path("dnsblast.werror"))
    built = chip_smoke.native_phase(hosts=200, also=chip_smoke.check_builds())
    assert "dnsblast.werror" not in built["also_build_s"]
    assert "fuzz_dnskey_cov" in built["also_build_s"]
    # the failed build left its directory empty
    os.rmdir(failed)
    runs = {"port-0": (("tests/test_torch_fastio.py",), ("-k",
                                                         "TestBatchIO"))}
    with pytest.raises(chip_smoke.PhaseError) as err:
        chip_smoke.make_check_phase(built["also_build_s"], (200, 50), runs)
    said = str(err.value)
    assert said.startswith("check: werror: cannot build dnsblast")
    assert "unused_planted" in said and "-Werror" in said
    [line] = [json.loads(line) for line in capsys.readouterr().out
              .splitlines() if line.startswith('{"check":')]
    report = line["check"]
    assert report["failed"] == ["werror"] and report["werror"] is None
    assert set(report["seconds"]) == {"werror", "fuzz", "asan"}
    assert all(r["reports"] == 0 for r in report["fuzz"].values())
    assert report["asan"]["passed"] == 7
