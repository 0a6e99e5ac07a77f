import os
import sys

# src-layout import without install; tests run on the host's real device
# count (1 CPU) — only launch/dryrun.py forces 512 placeholder devices.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute integration tests (subprocess meshes)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips without one")

try:                                   # hypothesis isn't baked into the image;
    import hypothesis                  # fall back to the deterministic shim
except ImportError:
    import types

    import _hypothesis_stub as _hs

    _mod = types.ModuleType("hypothesis")
    _mod.given, _mod.settings = _hs.given, _hs.settings
    _mod.strategies = types.ModuleType("hypothesis.strategies")
    _mod.strategies.integers = _hs.strategies.integers
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _mod.strategies
