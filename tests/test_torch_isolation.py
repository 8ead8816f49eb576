"""The port stands alone: no JAX, nothing of the JAX package, and no
silent run on the CPU.

(1) A fresh interpreter imports every ``repro_torch`` module (the
launchers too) and finds no ``jax*`` and no ``repro``/``repro.*`` module
loaded; an AST scan of the port's sources, ``chip_smoke.py``,
``chip_compare.py``, the example twins ``examples/torch_*.py`` and the
fault scripts ``scripts/torch_*.py`` finds no such import. (2) Without a CUDA device the entry points raise unless the
caller passes ``device="cpu"`` (``--device cpu`` on the launchers and the
examples).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SCRIPTS = sorted((ROOT / "scripts").glob("torch_*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_compare.py"] + \
    EXAMPLES + SCRIPTS


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


def test_the_scans_cover_the_encoder_decoder_modules():
    """whisper's config and the modules its path adds to are among the
    modules the two tests above import and scan."""
    for mod in ("repro_torch.configs.whisper_large_v3",
                "repro_torch.models.transformer",
                "repro_torch.core.stream"):
        assert mod in _modules()
    assert PORT / "configs" / "whisper_large_v3.py" in SOURCES


def test_the_scans_cover_the_moe_modules():
    """olmoe's config and the routed-MoE module are among the modules the
    import and the AST scans cover."""
    for mod in ("repro_torch.configs.olmoe_1b_7b", "repro_torch.models.moe"):
        assert mod in _modules()
    for path in (PORT / "configs" / "olmoe_1b_7b.py",
                 PORT / "models" / "moe.py"):
        assert path in SOURCES


def test_the_scans_cover_the_serving_stack_modules():
    """The fault plane, the continuous engine and the supervisor are among
    the modules the import and the AST scans cover."""
    for mod in ("repro_torch.core.faults", "repro_torch.serving.scheduler",
                "repro_torch.serving.supervisor"):
        assert mod in _modules()
    for path in (PORT / "core" / "faults.py",
                 PORT / "serving" / "scheduler.py",
                 PORT / "serving" / "supervisor.py"):
        assert path in SOURCES


def test_serving_stack_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.scheduler import ContinuousEngine
    from repro_torch.serving.supervisor import SupervisedEngine

    cfg = get_config("opt-proxy", smoke=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(cfg.model, gen, "cpu")
    for cls in (ContinuousEngine, SupervisedEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(cfg, params, max_len=32)
        assert cls(cfg, params, max_len=32, device="cpu").idle


def test_encoder_decoder_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.data import MarkovLM, calibration_batches
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import generate

    cfg = get_config("whisper-large-v3", smoke=True)
    mc = cfg.model
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_encdec_params(mc, gen, "cpu")
    calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7), 1, 2, 8)
    calib[0]["frames"] = torch.zeros((2, mc.encoder_seq_len, mc.d_model))
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize_model(cfg, params, calib)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(cfg, params, calib[0], max_new_tokens=2)
    res = generate(cfg, params, calib[0], device="cpu", max_new_tokens=2)
    assert res.tokens.shape == (2, 2)


def test_launchers_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    from repro_torch.launch import quantize, serve
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize.main(["--arch", "opt-proxy", "--smoke", "--out",
                       str(tmp_path), f"train.ckpt_dir={tmp_path / 'n'}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "opt-proxy", "--smoke"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_twins_raise_without_a_card(path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(path)], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr and not out.stdout


# the JAX registry's eleven architectures (its ARCH_IDS), then an id that
# neither package knows
JAX_ARCH_IDS = ["whisper-large-v3", "minicpm-2b", "h2o-danube-1.8b",
                "stablelm-1.6b", "internlm2-1.8b", "recurrentgemma-9b",
                "olmoe-1b-7b", "deepseek-v3-671b", "pixtral-12b",
                "falcon-mamba-7b", "opt-proxy"]


def _shared_fields(got, want, path="model"):
    """(path, port value, JAX value) of every field the port's config
    shares with the JAX config's, nested configs field by field."""
    import dataclasses
    names = {f.name for f in dataclasses.fields(want)}
    for f in dataclasses.fields(got):
        if f.name not in names:
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            yield from _shared_fields(a, b, f"{path}.{f.name}")
        else:
            yield f"{path}.{f.name}", a, b


@pytest.mark.parametrize("arch", JAX_ARCH_IDS + ["no-such-arch"])
def test_unported_arch_names_the_roadmap(arch):
    """Every architecture of the JAX package resolves in the port, full and
    smoke, to the JAX config's model fields (and quant group and
    blocksize); an unknown id raises KeyError in both."""
    from repro.configs import ARCH_IDS
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    if arch not in ARCH_IDS:
        for fn in (get_config, jget_config):
            with pytest.raises(KeyError):
                fn(arch)
        return
    for smoke in (False, True):
        got, want = get_config(arch, smoke=smoke), jget_config(arch,
                                                              smoke=smoke)
        shared = list(_shared_fields(got.model, want.model))
        assert len(shared) >= 40
        for path, a, b in shared:
            assert a == b, (smoke, path, a, b)
        assert got.model.layer_kinds == want.model.layer_kinds
        assert (got.quant.group_size, got.quant.blocksize) == \
            (want.quant.group_size, want.quant.blocksize)
