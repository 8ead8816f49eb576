"""The port's process-level fault checks, ``scripts/torch_resume_smoke.py``
and ``scripts/torch_chaos_soak.py``, against the JAX package's
``scripts/resume_smoke.py`` and ``scripts/chaos_soak.py``.

- the resume smoke on ``--device cpu``: a launcher process killed by the
  fault plane and resumed gives the clean run's artifact bitwise, under
  the fp16 and the int8 KV setting, and the resumed artifact serves; a
  stale trainer checkpoint at the children's default ``train.ckpt_dir``
  (another architecture's, which fails a child that reads it) leaves the
  script passing: its children read ``<work>/none``;
- the soak (``chaos`` marker, as ``tests/test_chaos.py``) finds no
  violation for seed 7, serving and quantize;
- the schedules: the port's ``_arm_string`` equals JAX's for the same
  rng, over both site tables;
- the quantize checker is not vacuous: one packed leaf flipped by hand
  is a Q2 violation.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import chaos_soak as jsoak  # noqa: E402
import torch_chaos_soak as tsoak  # noqa: E402
import torch_resume_smoke as tsmoke  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402


@pytest.fixture(autouse=True)
def disarmed():
    """Each test leaves both fault planes disarmed."""
    yield
    jfaults.PLANE.disarm()
    tfaults.PLANE.disarm()


def test_resume_smoke_on_cpu(monkeypatch, capsys):
    # the launcher children take this worker's share of the cores
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    assert tsmoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for what in ("fp16-kv matrix", "int8-kv matrix"):
        assert f"{what}: 108 leaves bitwise-identical" in out
    assert "OK: kill+resume matrix holds" in out


def test_resume_smoke_ignores_a_stale_default_checkpoint(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    import subprocess
    from repro_torch.configs import get_config
    from repro_torch.distributed.checkpoint import Checkpointer
    from repro_torch.launch.quantize import trained_params
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import init_train_state
    stale = tmp_path / "stale"
    ck = Checkpointer(str(stale))
    ck.save(1, init_train_state(get_config("internlm2-1.8b", smoke=True),
                                "cpu"), {"step": 1})
    ck.wait()
    gen = torch.Generator().manual_seed(0)
    like = T.init_params(get_config(tsmoke.ARCH, smoke=True).model, gen,
                         "cpu")
    with pytest.raises(Exception):      # a child that read it would fail
        trained_params(str(stale), like, torch.device("cpu"))
    # the children's default directory made the stale one: a
    # sitecustomize on their path rewrites TrainConfig's default
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import repro_torch.config as c\n"
        "_init = c.TrainConfig.__init__\n"
        "def __init__(self, *a, **kw):\n"
        "    _init(self, *a, **kw)\n"
        "    if self.ckpt_dir == '/tmp/repro_ckpt':\n"
        f"        self.ckpt_dir = {str(stale)!r}\n"
        "c.TrainConfig.__init__ = __init__\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    seen = subprocess.run(
        [sys.executable, "-c", "from repro_torch.config import Config; "
         "print(Config().train.ckpt_dir)"], env=tsmoke._env(),
        capture_output=True, text=True, check=True).stdout.strip()
    assert seen == str(stale)
    assert tsmoke.main(["--device", "cpu", "--int8-only"]) == 0
    out = capsys.readouterr().out
    assert "int8-kv matrix: 108 leaves bitwise-identical" in out
    assert "OK: kill+resume matrix holds" in out


@pytest.mark.chaos
def test_soak_serving_seed7():
    assert tsoak.run_serving_soak(7, smoke=True, device="cpu") == []


@pytest.mark.chaos
def test_soak_quantize_seed7():
    assert tsoak.run_quantize_soak(7, smoke=True, device="cpu") == []


@pytest.mark.parametrize("table", ["_SERVE_SITES", "_QUANT_KILL_SITES"])
@pytest.mark.parametrize("mode", [None, "corrupt"])
def test_arm_string_matches_jax(table, mode):
    assert getattr(tsoak, table) == getattr(jsoak, table)
    for seed in (0, 1, 2, 7, 1234):
        t = tsoak._arm_string(getattr(tsoak, table),
                              np.random.default_rng(seed), mode)
        j = jsoak._arm_string(getattr(jsoak, table),
                              np.random.default_rng(seed), mode)
        assert t == j and t


def test_quantize_checker_flags_a_flipped_leaf():
    cfg = tsoak._quant_cfg()
    params = tsoak._params(cfg.model, "cpu")
    clean, _ = tsoak._packed_leaves(cfg, params, tsoak._calib(cfg), "cpu")
    assert tsoak.check_packed(0, clean, list(clean), 1) == []
    flipped = list(clean)
    i = next(i for i, a in enumerate(flipped)
             if isinstance(a, np.ndarray) and a.dtype == np.uint8)
    flipped[i] = flipped[i].copy()
    flipped[i].reshape(-1)[0] ^= 1
    v = tsoak.check_packed(0, clean, flipped, 1)
    assert len(v) == 1 and f" Q2: leaf {i} differs" in v[0], v
