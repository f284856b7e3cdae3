"""The native fast path, ``native/fastio/{fastio,fastpath}.c``.

Importing this module builds the extension at first use
(:mod:`binder_torch.fastio_build`), loads it and puts it in
``sys.modules`` under this module's name, so ``from binder_torch import
_binderfastio`` yields the extension itself (its init function,
``PyInit__binderfastio``, matches the last component of the name).

A failed build raises ``fastio_build.NativeBuildError``, not
``ImportError``: the serve modules' ``except ImportError`` is the
reference's fallback for an extension nobody built, and must not turn
a broken build into a silent switch to the Python lane.
"""
import importlib.util
import sys

from binder_torch import fastio_build

_spec = importlib.util.spec_from_file_location(
    __name__, fastio_build.build("extension")[0])
_ext = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ext)
sys.modules[__name__] = _ext
