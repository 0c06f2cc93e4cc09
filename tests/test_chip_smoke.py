"""chip_smoke.py off the card: argument handling, refusal without a GPU,
and the oracles its solver phases rely on."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_args_default_one_card(smoke):
    assert smoke.parse_args([]).cards == 1
    assert smoke.parse_args(["--cards", "4"]).cards == 4


def test_args_reject_other_card_counts(smoke):
    with pytest.raises(SystemExit) as e:
        smoke.parse_args(["--cards", "2"])
    assert e.value.code != 0


def test_refuses_without_gpu(smoke, capsys):
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert "needs a GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_lone_script_fails_without_result(tmp_path):
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=tmp_path,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_lap2d_9pt_is_spd(smoke):
    a = smoke.lap2d_9pt(6).toarray()
    assert a.shape == (36, 36)
    np.testing.assert_array_equal(a, a.T)
    assert (np.diag(a) == 8).all()
    assert np.linalg.eigvalsh(a).min() > 0


def test_spd_banded_is_spd(smoke):
    a = smoke.spd_banded(200).toarray()
    np.testing.assert_array_equal(a, a.T)
    off = np.abs(a).sum(axis=1) - np.abs(np.diag(a))
    assert (np.diag(a) > off).all()  # strictly diagonally dominant
