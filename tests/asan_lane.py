"""pytest plugin: the fast-path suites on the port's ASan build.

``python -m binder_torch.check`` runs the sanitized suites in a child
``python -m pytest -p asan_lane --asan-native <dir> --asan-build <dir>``
(``tests/`` on ``PYTHONPATH``) with ``libasan`` preloaded, once it has
built ``extension.asan`` from those directories through
``binder_torch.fastio_build`` (the compilers never run under the
preload).  Before collection this plugin

- binds the name ``tests`` to this directory where an installed
  package of that name would shadow it (the suites import helpers as
  ``tests.<module>``, and a regular package anywhere on ``sys.path``
  wins over this directory, which has no ``__init__.py``);
- points ``fastio_build`` at the check's source and build
  directories, and makes ``fastio_build.build("extension")`` build (that
  is, find) ``extension.asan`` instead,
  so ``binder_torch._binderfastio`` and every test that asks the build
  for the extension load it.

After collection it deselects every test marked ``reference`` (those
import ``binder_tpu``, which stays on the CPU: the port's sanitized
suites run without it), then keeps one of N interleaved shares of the
rest with ``--asan-shard I/N``, so that the check can spread long
suites over processes.  At the end the plugin writes ``--asan-report``:
every ``_binderfastio`` shared object mapped into the process with the
sha256 of its bytes, every such module imported, every ``binder_tpu``
module loaded and the ``reference`` tests deselected, which the check
holds against the ASan artifact and against the rule that the
reference never loads.
"""
import hashlib
import json
import os
import sys
import types

from binder_torch import fastio_build

TESTS = os.path.dirname(os.path.abspath(__file__))
ASAN = "extension.asan"


def pytest_addoption(parser):
    parser.addoption("--asan-native", required=True,
                     help="fastio_build.NATIVE_DIR of the check")
    parser.addoption("--asan-build", required=True,
                     help="fastio_build.BUILD_DIR of the check")
    parser.addoption("--asan-report", required=True,
                     help="write the loaded extensions here (JSON)")
    parser.addoption("--asan-shard", default="0/1",
                     help="I/N: run the tests collected I, I+N, I+2N, ...")


#: node IDs of the ``reference`` tests deselected
_deselected = []


def pytest_collection_modifyitems(config, items):
    reference = [t for t in items if t.get_closest_marker("reference")]
    if reference:
        _deselected.extend(t.nodeid for t in reference)
        config.hook.pytest_deselected(items=reference)
        items[:] = [t for t in items if not t.get_closest_marker("reference")]
    i, n = (int(x) for x in config.getoption("--asan-shard").split("/"))
    if n > 1:
        config.hook.pytest_deselected(
            items=[t for k, t in enumerate(items) if k % n != i])
        items[:] = items[i::n]


def pytest_configure(config):
    fastio_build.NATIVE_DIR = config.getoption("--asan-native")
    fastio_build.BUILD_DIR = config.getoption("--asan-build")
    path = fastio_build.artifact_path(ASAN)
    if not os.path.exists(path):
        raise RuntimeError(f"{path} is not built: build it before the "
                           "preload")
    plain = fastio_build.build

    def build(name):
        return plain(ASAN if name == "extension" else name)

    fastio_build.build = build
    try:
        import tests
        bound = TESTS in list(getattr(tests, "__path__", ()))
    except ImportError:
        bound = False
    if not bound:
        tests = types.ModuleType("tests")
        tests.__path__ = [TESTS]
        sys.modules["tests"] = tests


def _sha256(path):
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:                   # unlinked while mapped
        return None


def pytest_unconfigure(config):
    with open("/proc/self/maps") as f:
        mapped = {path: _sha256(path) for path in
                  {line.split(None, 5)[5].strip()
                   for line in f if "_binderfastio" in line}}
    modules = {name: getattr(mod, "__file__", None)
               for name, mod in sys.modules.items()
               if name.endswith("._binderfastio")}
    reference = sorted(name for name in sys.modules
                       if name.split(".")[0] == "binder_tpu")
    with open(config.getoption("--asan-report"), "w") as f:
        json.dump({"mapped": mapped, "modules": modules,
                   "reference_modules": reference,
                   "deselected_reference": _deselected}, f)
