"""The port stands alone: no JAX, nothing of the JAX package, and no
silent run on the CPU.

(1) A fresh interpreter imports every ``repro_torch`` module and finds no
``jax*`` and no ``repro``/``repro.*`` module loaded; an AST scan of the
port's sources, ``chip_smoke.py`` and ``chip_compare.py`` finds no such
import. (2) Without a CUDA device the entry points raise unless the caller
passes ``device="cpu"``.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_compare.py"]


def _modules():
    return ["repro_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                      .parts).replace(".__init__", "")
            for p in sorted(PORT.rglob("*.py"))]


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import sys, importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {name}"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import generate

    cfg = get_config("opt-proxy", smoke=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(cfg.model, gen, "cpu")
    calib = calibration_batches(MarkovLM(256, seed=7), 1, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize_model(cfg, params, calib)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(cfg, params, calib[0], max_new_tokens=2)
    # asked for explicitly, the CPU runs the plain versions
    res = generate(cfg, params, calib[0], device="cpu", max_new_tokens=2)
    assert res.tokens.shape == (2, 2)


def test_unported_arch_names_the_roadmap():
    from repro_torch.configs import get_config
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("minicpm-2b")
