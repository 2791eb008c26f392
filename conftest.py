"""Repository-wide test guard: ``REPRO_NO_JAX`` is restored after every
test to the value it had when the test run started (set or unset).

``tools/check_static.py --mode nojax`` sets the variable in its own
process and never unsets it; a test that runs that code in a pytest
worker would otherwise mask jax for every test the worker runs later
(``repro.core.accel.jax_available`` reads the environment on each call).
A run started with the variable set, as the no-jax CI job is
(``REPRO_NO_JAX=1 ./ci.sh``), keeps it set. Imports nothing of ``repro``
or jax.
"""
import os

import pytest

_NAME = "REPRO_NO_JAX"
#: the variable's value when the test run started; None when it was unset
REPRO_NO_JAX_AT_START = os.environ.get(_NAME)


@pytest.fixture(scope="session")
def repro_no_jax_at_start():
    """``REPRO_NO_JAX`` as it was when the test run started (None: unset)."""
    return REPRO_NO_JAX_AT_START


@pytest.fixture(autouse=True)
def _restore_repro_no_jax():
    yield
    if REPRO_NO_JAX_AT_START is None:
        os.environ.pop(_NAME, None)
    else:
        os.environ[_NAME] = REPRO_NO_JAX_AT_START
