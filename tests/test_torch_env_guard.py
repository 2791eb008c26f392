"""The repository-root ``conftest.py`` restores ``REPRO_NO_JAX`` after
every test. The first test sets the variable directly, as
``tools/check_static.py --mode nojax`` does, without monkeypatch; the
later ones, which pytest runs after it in the same process (one worker
under ``--dist loadfile``), see the run's start value again."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_a_test_may_set_the_variable_for_good():
    os.environ["REPRO_NO_JAX"] = "1"
    assert os.environ["REPRO_NO_JAX"] == "1"


def test_the_start_value_is_back(repro_no_jax_at_start):
    assert os.environ.get("REPRO_NO_JAX") == repro_no_jax_at_start


def test_a_masking_value_is_back_after_unset(repro_no_jax_at_start):
    os.environ.pop("REPRO_NO_JAX", None)
    if repro_no_jax_at_start is not None:
        os.environ["REPRO_NO_JAX"] = "0"


def test_the_start_value_is_back_again(repro_no_jax_at_start):
    assert os.environ.get("REPRO_NO_JAX") == repro_no_jax_at_start


def test_sys_path_probe(request):
    """Run by the next test in a fresh pytest process, where the variable
    below names a file: records ``sys.path``, whether the root conftest
    was loaded, and the file ``conftest`` names. Elsewhere it does
    nothing."""
    out = os.environ.get("REPRO_SYS_PATH_PROBE")
    if out:
        import conftest
        plugins = request.config.pluginmanager.get_plugins()
        Path(out).write_text(json.dumps({
            "sys_path": sys.path, "conftest": conftest.__file__,
            "root_conftest": any(getattr(m, "__file__", None) ==
                                 str(ROOT / "conftest.py") for m in plugins)}))


def test_the_root_conftest_changes_no_import(tmp_path):
    """``sys.path`` is the same with the root conftest as without it
    (``--confcutdir=tests`` leaves it out): pytest puts its directory, the
    repository root, on the path, and ``python -m pytest`` run from the
    root has put it there already. The name ``conftest`` still means
    ``tests/conftest.py``, whose helpers other tests import (``from
    conftest import TINY_SHAPE``)."""
    seen = {}
    for name, extra in (("with", []),
                        ("without", ["--confcutdir", str(ROOT / "tests")])):
        out = tmp_path / f"{name}.json"
        subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             f"{__file__}::test_sys_path_probe", *extra],
            cwd=ROOT, env={**os.environ, "REPRO_SYS_PATH_PROBE": str(out)},
            check=True, capture_output=True, timeout=300)
        seen[name] = json.loads(out.read_text())
    assert seen["with"]["root_conftest"]
    assert not seen["without"]["root_conftest"]
    assert seen["with"]["sys_path"] == seen["without"]["sys_path"]
    for run in seen.values():
        assert Path(run["conftest"]) == ROOT / "tests" / "conftest.py"
