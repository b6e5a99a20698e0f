"""Test config: single-device CPU (the dry-run forces 512 devices in its own
subprocess only — never here), fast hypothesis profile for the 1-core CI.

``hypothesis`` is optional: on a clean environment without it, a minimal
stub is installed into ``sys.modules`` *before* test modules are collected,
whose ``@given`` decorator marks the test as skipped.  Plain (non-property)
tests in the same modules still collect and run.
"""

try:
    import hypothesis

    hypothesis.settings.register_profile(
        "ci", max_examples=15, deadline=None, derandomize=True
    )
    hypothesis.settings.load_profile("ci")
except ModuleNotFoundError:
    import sys
    import types

    import pytest

    _SKIP = pytest.mark.skip(reason="hypothesis not installed")

    def _given(*_a, **_k):
        def deco(fn):
            # Replace the property test with an argument-less skip so pytest
            # does not try to fill the hypothesis-strategy parameters.
            @_SKIP
            def skipped():  # pragma: no cover - never runs
                pass

            skipped.__name__ = fn.__name__
            skipped.__doc__ = fn.__doc__
            return skipped

        return deco

    def _settings(*_a, **_k):
        def deco(fn):
            return fn

        return deco

    def _strategy(*_a, **_k):
        return None

    hyp = types.ModuleType("hypothesis")
    hyp.given = _given
    hyp.settings = _settings
    hyp.__getattr__ = lambda name: _strategy

    st = types.ModuleType("hypothesis.strategies")
    st.__getattr__ = lambda name: _strategy

    hyp.strategies = st
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips itself without one"
    )
