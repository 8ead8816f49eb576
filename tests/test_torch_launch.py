"""The port's launchers and example twins against the JAX package's.

Quantize: the port's and the JAX package's ``launch.quantize.main`` start
from one JAX trainer checkpoint (``train.ckpt_dir``, a smoke TrainState
from ``PRNGKey(0)``), on opt-proxy smoke and internlm2 smoke, at model
dtype float32 and ``MarkovLM(vocab, seed=7)`` 3 × 4 × 32 calibration (JAX
with ``quant.jit_capture=false``): the inputs of
``tests/test_torch_pipeline.py``, so its pins hold here (``PINS``): record
names, shapes and modes equal, ``iters`` within the pin, Γ histories to
its rtol, packed codes differing in ≤ 1e-2 of the bytes and the packed
models' logits within the pin. The port's fresh init (torch seed 0) is
not JAX's, so the agreement also shows the checkpoint was read.

Serve: the JAX artifact goes through the JAX ``load_artifact`` →
``params_from_numpy`` → the port's ``save_artifact``; the port's
``launch.serve --params`` then prints JAX ``launch.serve``'s greedy
tokens, on opt-proxy (bf16 cache) and internlm2 (``serve.kv_cache=int8``).
``--pack-rtn`` on the JAX init gives JAX ``--pack-rtn``'s tokens.

Resume: a quantize run interrupted at step k (a wrapper of the plan
executor raises) and resumed with ``quant.resume=auto`` writes an artifact
bitwise (sha256) an uninterrupted run's; a checkpoint of another config,
or a corrupt one, warns and the run starts fresh with the same artifact.
``serve.scheduler=continuous`` and ``serve.supervise=true`` (under an
armed ``serve.engine_step`` kill) give JAX ``launch.serve``'s tokens. The
options not ported raise and name their ROADMAP item, and the two
example twins run with ``--device cpu`` and print their checks as OK.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import hashlib
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed.checkpoint import Checkpointer as JCheckpointer
from repro.distributed.checkpoint import load_artifact as jload_artifact
from repro.launch import quantize as jlaunch_quantize
from repro.launch import serve as jlaunch_serve
from repro.models import transformer as JT
from repro.training.train_step import init_train_state
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import plan as tplan
from repro_torch.core.quant import quantized_leaves
from repro_torch.distributed import checkpoint as C
from repro_torch.launch import quantize as tlaunch_quantize
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.models import transformer as TT

from test_torch_models import rel, to_numpy
from test_torch_pipeline import PINS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = ["quant.calib_batches=3", "quant.calib_batch_size=4",
         "quant.calib_seq_len=32"]
F32 = ["model.dtype=float32"]
NAMES = {"opt-proxy": "opt-proxy-smoke", "internlm2-1.8b": "internlm2-smoke"}
KV = {"opt-proxy": "fp16", "internlm2-1.8b": "int8"}


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _seqs(out: str):
    """The ``seq<i>: [...]`` lines a serve launcher prints."""
    return [json.loads(m) for m in re.findall(r"^  seq\d+: (\[.*\])$", out,
                                              re.M)]


@pytest.fixture(scope="module", params=list(NAMES))
def quantized(request, tmp_path_factory):
    arch = request.param
    tmp = tmp_path_factory.mktemp(arch)
    ck = str(tmp / "train_ckpt")
    jcfg = jget_config(arch, smoke=True)
    state = init_train_state(jcfg, jax.random.PRNGKey(0))
    JCheckpointer(ck, async_write=False).save(5, state)
    common = ["--arch", arch, "--smoke"]
    over = [f"train.ckpt_dir={ck}"] + CALIB + F32
    jlaunch_quantize.main(common + ["--out", str(tmp / "jax")] + over
                          + ["quant.jit_capture=false"])
    path, report = tlaunch_quantize.main(
        common + ["--out", str(tmp / "torch"), "--device", "cpu"] + over)
    return dict(arch=arch, tmp=tmp, path=path, report=report,
                jdir=str(tmp / "jax"), tdir=str(tmp / "torch"))


def test_quantize_reports_match_jax(quantized):
    name = NAMES[quantized["arch"]]
    with open(os.path.join(quantized["jdir"], f"{name}.report.json")) as f:
        jl = json.load(f)
    with open(os.path.join(quantized["tdir"], f"{name}.report.json")) as f:
        tl = json.load(f)
    d_iters, g_rtol, _ = PINS[quantized["arch"]]
    assert [r["name"] for r in tl] == [r["name"] for r in jl]
    assert all(r["mode"] == "rpiq" for r in tl)
    for a, b in zip(tl, jl):
        assert (a["mode"], a["shape"]) == (b["mode"], b["shape"]), a["name"]
        assert abs(a["iters"] - b["iters"]) <= d_iters, a["name"]
        n = min(len(a["gamma"]), len(b["gamma"]))
        np.testing.assert_allclose(a["gamma"][:n], b["gamma"][:n],
                                   rtol=g_rtol)


def test_quantize_artifacts_match_jax(quantized):
    arch, name = quantized["arch"], NAMES[quantized["arch"]]
    jpacked_raw = jload_artifact(os.path.join(quantized["jdir"],
                                              f"{name}.params.pkl"))
    jpacked = params_from_numpy(to_numpy(jpacked_raw))
    tpacked = params_from_numpy(C.load_artifact(quantized["path"]))
    ours, theirs = (dict(quantized_leaves(p["layers"]))
                    for p in (tpacked, jpacked))
    assert list(ours) == list(theirs)
    diff = sum(int((qt.packed != theirs[k].packed).sum())
               for k, qt in ours.items())
    total = sum(qt.packed.numel() for qt in ours.values())
    assert diff / total <= 1e-2
    cfg = tget_config(arch, smoke=True)
    cfg.model.dtype = "float32"
    jcfg = jget_config(arch, smoke=True)
    jcfg.model.dtype = "float32"
    toks = np.random.RandomState(0).randint(0, cfg.model.vocab_size,
                                            (2, 16))
    lt = TT.forward(cfg.model, tpacked, torch.from_numpy(toks))
    lj, _ = JT.forward(jcfg.model, jpacked_raw, toks)
    assert rel(lt.numpy(), lj) <= PINS[arch][2]


def _jax_load_to_device(path):
    """The JAX ``load_artifact`` with its numpy leaves put on the device:
    the JAX ``launch.serve --params`` hands the numpy tree to the static
    ``generate``, whose scanned decode step then indexes a numpy
    embedding with a traced token and raises (TracerArrayConversionError,
    a fault of the reference, ROADMAP.md §3)."""
    return jax.tree_util.tree_map(jnp.asarray, jload_artifact(path))


def test_serve_gives_jax_serve_tokens(quantized, capsys, monkeypatch):
    arch, name = quantized["arch"], NAMES[quantized["arch"]]
    monkeypatch.setattr(jlaunch_serve, "load_artifact", _jax_load_to_device)
    jart = os.path.join(quantized["jdir"], f"{name}.params.pkl")
    tart = str(quantized["tmp"] / "from_jax.params.pkl")
    C.save_artifact(tart, params_from_numpy(to_numpy(jload_artifact(jart))))
    common = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
              "8"]
    over = F32 + ["serve.max_new_tokens=6", f"serve.kv_cache={KV[arch]}"]
    capsys.readouterr()
    jlaunch_serve.main(common + ["--params", jart] + over)
    want = _seqs(capsys.readouterr().out)
    res = tlaunch_serve.main(common + ["--params", tart, "--device", "cpu"]
                             + over)
    out = capsys.readouterr().out
    assert "(integrity-checked)" in out
    assert len(want) == 2 and _seqs(out) == want
    assert res.tokens.tolist() == want


def test_serve_pack_rtn_gives_jax_tokens(tmp_path, capsys):
    """--pack-rtn on float weights: JAX's PRNGKey(0) init, carried to the
    port as a float artifact."""
    jcfg = jget_config("opt-proxy", smoke=True)
    art = str(tmp_path / "float.params.pkl")
    C.save_artifact(art, params_from_numpy(to_numpy(JT.init_params(
        jcfg.model, jax.random.PRNGKey(0)))))
    common = ["--arch", "opt-proxy", "--smoke", "--pack-rtn", "--batch",
              "2", "--prompt-len", "8"]
    over = F32 + ["serve.max_new_tokens=6"]
    capsys.readouterr()
    jlaunch_serve.main(common + over)
    want = _seqs(capsys.readouterr().out)
    tlaunch_serve.main(common + ["--params", art, "--device", "cpu"] + over)
    out = capsys.readouterr().out
    assert "RTN-packed" in out
    assert len(want) == 2 and _seqs(out) == want


def test_serve_frontend_prepends_patch_embeddings(capsys, monkeypatch):
    """pixtral smoke: each request carries min(frontend_tokens, 8) = 8
    seeded patch embeddings in front of its 8 prompt tokens, so decode
    starts at position 16; the tokens are generate's on the same batch."""
    from repro_torch.core.pipeline import pack_for_serving
    from repro_torch.data import MarkovLM
    from repro_torch.serving import engine
    starts = []
    loop = engine.DecodeLoop

    class Loop(loop):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            starts.append(self.pos.tolist())

    monkeypatch.setattr(engine, "DecodeLoop", Loop)
    res = tlaunch_serve.main(["--arch", "pixtral-12b", "--smoke",
                              "--pack-rtn", "--batch", "2", "--prompt-len",
                              "8", "--device", "cpu",
                              "serve.max_new_tokens=4"])
    assert starts == [[16, 16]]
    assert _seqs(capsys.readouterr().out) == res.tokens.tolist()
    cfg = tget_config("pixtral-12b", smoke=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = pack_for_serving(cfg, TT.init_params(cfg.model, gen, "cpu"))
    gen.manual_seed(3)
    batch = MarkovLM(cfg.model.vocab_size, seed=3).batch(2, 8)
    batch["embeds"] = torch.randn((2, 8, cfg.model.d_model), generator=gen)
    want = engine.generate(cfg, params, batch, device="cpu",
                           max_new_tokens=4)
    assert torch.equal(res.tokens, want.tokens)
    del batch["embeds"]
    assert not torch.equal(engine.generate(cfg, params, batch, device="cpu",
                                           max_new_tokens=4).tokens,
                           want.tokens)


@pytest.mark.parametrize("override", ["serve.scheduler=continuous",
                                      "serve.supervise=true"])
def test_serve_scheduler_options_give_jax_tokens(override, tmp_path, capsys):
    """``serve.scheduler=continuous`` (2 lanes, 3 requests, prefill chunk
    3) gives JAX ``launch.serve``'s tokens on the ``--pack-rtn`` JAX init;
    so does ``serve.supervise=true`` with ``faults.arm=
    serve.engine_step@3`` armed in both launchers: one restart, every
    request replayed to the same tokens."""
    from repro.core import faults as jfaults
    from repro_torch.core import faults as tfaults
    jcfg = jget_config("opt-proxy", smoke=True)
    art = str(tmp_path / "float.params.pkl")
    C.save_artifact(art, params_from_numpy(to_numpy(JT.init_params(
        jcfg.model, jax.random.PRNGKey(0)))))
    common = ["--arch", "opt-proxy", "--smoke", "--pack-rtn", "--batch",
              "3", "--prompt-len", "8"]
    over = F32 + ["serve.max_new_tokens=5", "serve.scheduler=continuous",
                  "serve.max_batch=2", "serve.prefill_chunk=3"]
    if override == "serve.supervise=true":
        over += [override, "faults.arm=serve.engine_step@3"]
    capsys.readouterr()
    try:
        jlaunch_serve.main(common + over)
        want = _seqs(capsys.readouterr().out)
        done = tlaunch_serve.main(common + ["--params", art, "--device",
                                            "cpu"] + over)
    finally:
        jfaults.PLANE.disarm()
        tfaults.PLANE.disarm()
    out = capsys.readouterr().out
    assert len(want) == 3 and _seqs(out) == want
    assert [f.tokens.tolist() for f in done.values()] == want
    assert all(f.status == "ok" for f in done.values())
    if "supervise" in override:
        assert "'restarts': 1" in out and "fault plane armed" in out


def _quantize(tmp, arch, out, extra=()):
    return tlaunch_quantize.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--out",
         str(tmp / out), f"train.ckpt_dir={tmp / 'none'}",
         "quant.calib_batches=2", "quant.calib_batch_size=2",
         "quant.calib_seq_len=16"] + list(extra))


class _Interrupt(Exception):
    pass


@pytest.mark.parametrize("arch,k", [("opt-proxy", 2),
                                    ("falcon-mamba-7b", 2),
                                    ("falcon-mamba-7b", 3)])
def test_interrupted_then_resumed_is_bitwise_uninterrupted(arch, k, tmp_path,
                                                           monkeypatch):
    ref, _ = _quantize(tmp_path, arch, "ref")
    ck = [f"quant.ckpt_dir={tmp_path / 'ck'}", "quant.resume=auto"]
    real, calls = tplan.execute_plan, []

    def interrupt_at_step_k(*args, **kwargs):
        calls.append(1)
        if len(calls) == k:
            raise _Interrupt(f"step {k}")
        return real(*args, **kwargs)

    monkeypatch.setattr(tplan, "execute_plan", interrupt_at_step_k)
    with pytest.raises(_Interrupt):
        _quantize(tmp_path, arch, "run", ck)
    monkeypatch.setattr(tplan, "execute_plan", real)
    assert C.Checkpointer(str(tmp_path / "ck")).latest_step() == k - 2
    path, report = _quantize(tmp_path, arch, "run", ck)
    assert report.pipeline_stats["resumed_at"] == k - 1
    assert report.pipeline_stats["steps"] == len(report.layer_step_seconds)
    assert _sha(path) == _sha(ref)
    with open(str(ref).replace(".params.pkl", ".report.json")) as f:
        want = [(r["name"], r["mode"], r["iters"], r["gamma"])
                for r in json.load(f)]
    with open(path.replace(".params.pkl", ".report.json")) as f:
        got = [(r["name"], r["mode"], r["iters"], r["gamma"])
               for r in json.load(f)]
    assert got == want


@pytest.mark.parametrize("damage", ["other_config", "corrupt"])
def test_unusable_checkpoint_warns_and_starts_fresh(damage, tmp_path):
    arch = "opt-proxy"
    ck = [f"quant.ckpt_dir={tmp_path / 'ck'}", "quant.resume=auto"]
    first = ["quant.rpiq_alpha=0.02"] if damage == "other_config" else []
    _quantize(tmp_path, arch, "first", ck + first)
    ckpt = C.Checkpointer(str(tmp_path / "ck"))
    if damage == "corrupt":
        npz = os.path.join(str(tmp_path / "ck"),
                           f"step_{ckpt.latest_step():09d}", "arrays.npz")
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)
    ref, _ = _quantize(tmp_path, arch, "ref")
    match = "fingerprint mismatch" if damage == "other_config" else "corrupt"
    with pytest.warns(RuntimeWarning, match=match):
        path, report = _quantize(tmp_path, arch, "again", ck)
    assert "resumed_at" not in report.pipeline_stats
    assert _sha(path) == _sha(ref)


@pytest.mark.parametrize("launcher,override,item", [
    ("quantize", "quant.batched_executor=false", 9),
])
def test_options_not_ported_raise(launcher, override, item, tmp_path):
    mod = tlaunch_quantize if launcher == "quantize" else tlaunch_serve
    argv = ["--arch", "opt-proxy", "--smoke", "--device", "cpu"]
    if launcher == "quantize":
        argv += ["--out", str(tmp_path), f"train.ckpt_dir={tmp_path / 'n'}"]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md, queue 1 item {item}"):
        mod.main(argv + CALIB + [override])


@pytest.mark.parametrize("launcher", ["quantize", "serve"])
@pytest.mark.parametrize("arch,override", [
    ("deepseek-v3-671b", "model.mla.qk_rope_head_dim=16"),
    ("deepseek-v3-671b", "model.mtp_depth=0"),
    ("recurrentgemma-9b", "model.rglru.conv1d_width=2"),
    ("recurrentgemma-9b", "model.rglru.lru_width=32")])
def test_new_arch_override_keys_are_taken(launcher, arch, override,
                                          tmp_path):
    """The JAX keys of the MLA, MTP and RG-LRU configs are taken by both
    launchers on the two architectures that read them, and the run goes
    to its end at the overridden width."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu"]
    if launcher == "quantize":
        argv += ["--out", str(tmp_path), f"train.ckpt_dir={tmp_path / 'n'}",
                 "quant.calib_batches=1", "quant.calib_batch_size=2",
                 "quant.calib_seq_len=16"]
    else:
        argv += ["--batch", "2", "--prompt-len", "8",
                 "serve.max_new_tokens=2"]
    mod = tlaunch_quantize if launcher == "quantize" else tlaunch_serve
    out = mod.main(argv + [override])
    if launcher == "quantize":
        assert os.path.exists(out[0])
    else:
        assert tuple(out.tokens.shape) == (2, 2)


# the fields of distribution, each set away from its JAX default
SHARDING_OVERRIDES = (
    "parallel.data=2", "parallel.model=2", "parallel.pod=2",
    "parallel.fsdp=false", "parallel.sp=true", "parallel.ep=false",
    "parallel.pipeline_stages=2", "parallel.pp_microbatches=4",
    "parallel.grad_compression=int8", "parallel.overlap_collectives=false",
    "parallel.ep_local_dispatch=false", "parallel.scan_layers=false")


@pytest.mark.parametrize("launcher", ["quantize", "serve"])
@pytest.mark.parametrize("override", [
    "quant.act_order=true", "quant.keep_best_projection=false",
    "serve.quantized=false", "quant.moe_flip_budget=0.25",
    "model.opt_attention=false", "quant.jit_capture=false",
    "quant.gptq_impl=xla", "quant.rpiq_impl=xla", "quant.rpiq_impl=pallas",
    "quant.batched_executor=false", "parallel.remat=none",
    "parallel.int8_optimizer_state=true", "train.lr=1e-3",
    "train.schedule=wsd", "model.param_dtype=bfloat16",
    *SHARDING_OVERRIDES])
def test_jax_override_keys_are_taken(launcher, override, tmp_path):
    """Keys the JAX ``Config`` takes are taken by both launchers and run to
    the end: the ones read nowhere in the reference (``quant.act_order``,
    ``quant.keep_best_projection``, ``serve.quantized``), the two the
    overlap schedule reads (``quant.moe_flip_budget``,
    ``quant.jit_capture``), here under serial, the stages' route
    (``quant.rpiq_impl=pallas``, the port's one route) and the naive
    attention baseline (``model.opt_attention=false``). The JAX package's
    plain stage route (``quant.gptq_impl`` / ``quant.rpiq_impl`` ``xla``) and
    its per-linear executor baseline (``quant.batched_executor=false``)
    raise in the quantize launcher, which runs the executor; each names
    its ROADMAP item. Training's keys are taken (``parallel.remat``,
    ``parallel.int8_optimizer_state``, ``train.*``, ``model.param_dtype``;
    every ``train.*`` key in :func:`test_every_train_key_is_taken`), and
    so is each sharding field set away from its default: neither launcher
    reads them, in the reference as here (sharded training reads
    ``fsdp``, ``ep_local_dispatch`` and ``sp``,
    tests/test_torch_sharded_train.py)."""
    argv = ["--arch", "opt-proxy", "--smoke", "--device", "cpu"]
    if launcher == "quantize":
        argv += ["--out", str(tmp_path), f"train.ckpt_dir={tmp_path / 'n'}",
                 "quant.calib_batches=1", "quant.calib_batch_size=2",
                 "quant.calib_seq_len=16"]
    else:
        argv += ["--batch", "2", "--prompt-len", "8",
                 "serve.max_new_tokens=2"]
    mod = tlaunch_quantize if launcher == "quantize" else tlaunch_serve
    refused = {}
    if launcher == "quantize":
        refused.update({"quant.batched_executor=false": 9,
                        "quant.gptq_impl=xla": 9,
                        "quant.rpiq_impl=xla": 9})
    if override in refused:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md, queue 1 item "
                                 f"{refused[override]}"):
            mod.main(argv + [override])
        return
    out = mod.main(argv + [override])
    if launcher == "quantize":
        assert os.path.exists(out[0])
    else:
        assert tuple(out.tokens.shape) == (2, 2)


def test_every_train_key_is_taken():
    """Each JAX ``train.*`` and ``parallel.*`` field exists in the port's
    config with the JAX default; every ``train.*`` key takes an override
    as the JAX config takes it."""
    from repro.config import apply_overrides as japply
    from repro_torch.config import apply_overrides as tapply
    jc, tc = jget_config("opt-proxy"), tget_config("opt-proxy")
    for section in ("train", "parallel"):
        jd, td = vars(getattr(jc, section)), vars(getattr(tc, section))
        assert jd == td, section
    values = {"schedule": "wsd", "ckpt_dir": "elsewhere"}
    for key, default in vars(jc.train).items():
        if key in values:
            value = values[key]
        else:
            value = ("false" if isinstance(default, bool)
                     else str(default * 2 + 1))
        japply(jc, {f"train.{key}": value})
        tapply(tc, {f"train.{key}": value})
    assert vars(tc.train) == vars(jc.train) != vars(
        tget_config("opt-proxy").train)


@pytest.mark.parametrize("key", ["quant.gptq_impl", "quant.rpiq_impl"])
def test_unknown_stage_route_raises(key, tmp_path):
    """A stage route that neither package knows raises ``ValueError``."""
    argv = ["--arch", "opt-proxy", "--smoke", "--device", "cpu",
            "--out", str(tmp_path), f"train.ckpt_dir={tmp_path / 'n'}",
            "quant.calib_batches=1", "quant.calib_batch_size=2",
            "quant.calib_seq_len=16", f"{key}=triton"]
    with pytest.raises(ValueError, match=key):
        tlaunch_quantize.main(argv)


@pytest.mark.parametrize("script,check", [
    ("torch_quickstart.py",
     r"packed int4 vs refined-grid float: rel err \S+ \(OK\)"),
    ("torch_quantize_and_serve.py", r"request 3: prompt=\[.*\] -> \[.*\]"),
])
def test_example_twins_run_on_the_cpu(script, check):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                       script),
                          "--device", "cpu"], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(check, out.stdout), out.stdout
    assert "MISMATCH" not in out.stdout
