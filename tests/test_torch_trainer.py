"""The port's trainer, checkpoints and launcher, on the CPU, against the
JAX package's trainer (opt-proxy smoke at model dtype float32, batch 4 ×
16, unless marked).

- A port checkpoint (3 steps) restored by JAX's ``train``, which runs 2
  more steps, gives the losses and parameters of the port running those 2
  steps itself (≤ 1e-5 relative; the parameters over the whole tree),
  with fp32 and with int8 moments (JAX restores the ``.q`` / ``.scale``
  leaves; the parameters at the int8 pin of
  tests/test_torch_train_int8.py, 1e-2); and the reverse, a JAX
  checkpoint continued by the port.
- A run stopped by SIGTERM checkpoints at the next step boundary; rerun,
  it resumes and ends bitwise the uninterrupted run's state, the data
  stream's position included.
- ``launch.train`` runs on the CPU, resumes from its checkpoint, and its
  checkpoint quantizes through ``launch.quantize train.ckpt_dir=``;
  ``--mesh 1,1`` and ``train(mesh=...)`` at a world of one end bitwise the
  one-device run, ``parallel.data`` / ``parallel.fsdp`` are taken
  (tests/test_torch_sharded_train.py holds sharded training on four
  ranks); ``examples/torch_train_small_lm.py`` runs.

On the card (``gpu``): every CUDA wrapper of ``kernels/ops.py`` raises on
an input that requires grad (the scan's dispatcher takes such inputs
through its autograd Function instead, its backward the
``selective_scan_bwd`` kernel); an opt-proxy and a falcon-mamba smoke
train step at their own bf16 on the card against the same step on the
CPU (loss and parameters ≤ 1e-2 relative: the two devices sum the fp32
products in other orders and round the bf16 activations apart).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

import contextlib
import os
import shutil
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import MarkovLM as JMarkovLM
from repro.training.trainer import train as jtrain
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import unstack_layers
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.distributed.checkpoint import Checkpointer, tree_paths
from repro_torch.kernels import ops as tops
from repro_torch.launch import quantize as tlaunch_quantize
from repro_torch.launch import train as tlaunch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.training import train_step as TTS
from repro_torch.training.trainer import train as ttrain

ROOT = os.path.join(os.path.dirname(__file__), "..")


def configs(steps: int, ckpt_dir, int8: bool = False):
    out = []
    for get in (jget_config, tget_config):
        c = get("opt-proxy", smoke=True)
        c.model.dtype = "float32"
        c.parallel.int8_optimizer_state = int8
        t = c.train
        t.steps, t.ckpt_dir, t.ckpt_every = steps, str(ckpt_dir), 3
        t.global_batch_size, t.seq_len = 4, 16
        t.lr, t.warmup_steps, t.ckpt_async = 3e-3, 2, False
        out.append(c)
    return out


def losses(out):
    return [h["loss"] for h in out["history"]]


def params_flat(state):
    return {k: np.asarray(v.detach().float().numpy() if isinstance(
        v, torch.Tensor) else v, dtype=np.float64)
        for k, v in tree_paths(state.params if hasattr(state, "params")
                               else state)}


def tree_rel(got, want):
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return float(np.sqrt(num / sum(float(np.sum(w * w))
                                   for w in want.values())))


def jax_params_flat(jstate):
    return params_flat(jax.tree_util.tree_map(np.asarray, jstate.params))


@pytest.mark.parametrize("int8", [False, True])
def test_port_checkpoint_continues_in_jax(int8, tmp_path):
    _, t3 = configs(3, tmp_path / "a", int8)
    ttrain(t3, TMarkovLM(128, seed=0), device="cpu", verbose=False)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    j5, _ = configs(5, tmp_path / "a", int8)
    jout = jtrain(j5, JMarkovLM(128, seed=0), verbose=False)
    _, t5 = configs(5, tmp_path / "b", int8)
    tout = ttrain(t5, TMarkovLM(128, seed=0), device="cpu", verbose=False)
    assert [h["step"] for h in jout["history"]] == [3, 4]
    for a, b in zip(losses(tout), losses(jout)):
        assert abs(a - b) <= 1e-5 * abs(b)
    # int8: the first continued step stores moment codes one apart at
    # rounding ties, which the second step's update amplifies
    # (tests/test_torch_train_int8.py; 5.6e-4 seen)
    assert tree_rel(params_flat(tout["state"]),
                    jax_params_flat(jout["state"])) <= (1e-2 if int8
                                                         else 1e-5)


def test_jax_checkpoint_continues_in_port(tmp_path):
    j3, _ = configs(3, tmp_path / "a")
    jtrain(j3, JMarkovLM(128, seed=0), verbose=False)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    j5, _ = configs(5, tmp_path / "a")
    jout = jtrain(j5, JMarkovLM(128, seed=0), verbose=False)
    _, t5 = configs(5, tmp_path / "b")
    tout = ttrain(t5, TMarkovLM(128, seed=0), device="cpu", verbose=False)
    assert [h["step"] for h in tout["history"]] == [3, 4]
    for a, b in zip(losses(tout), losses(jout)):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert tree_rel(params_flat(tout["state"]),
                    jax_params_flat(jout["state"])) <= 1e-5


class _SigtermAt(TMarkovLM):
    """A stream that sends this process SIGTERM as it makes batch
    ``at`` (in the trainer's prefetch thread; the trainer reads the flag
    at a later step boundary)."""

    def __init__(self, *a, at: int, **kw):
        super().__init__(*a, **kw)
        self.at = at

    def batch(self, *a, **kw):
        if self.step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return super().batch(*a, **kw)


def test_sigterm_resume_is_bitwise(tmp_path):
    _, cfg = configs(12, tmp_path / "ref")
    ref = ttrain(cfg, TMarkovLM(128, seed=0), device="cpu", verbose=False)
    _, cfg = configs(12, tmp_path / "run")
    first = ttrain(cfg, _SigtermAt(128, seed=0, at=4), device="cpu",
                   verbose=False)
    stopped = len(first["history"])
    assert 0 < stopped < 12
    ck = Checkpointer(str(tmp_path / "run"))
    assert ck.latest_step() == stopped
    second = ttrain(cfg, TMarkovLM(128, seed=0), device="cpu",
                    verbose=False)
    assert [h["step"] for h in second["history"]] == list(range(stopped, 12))
    assert losses(first) + losses(second) == losses(ref)
    want, want_extra = Checkpointer(str(tmp_path / "ref")).load_arrays()
    got, got_extra = ck.load_arrays()
    assert got_extra == want_extra == {"step": 12,
                                       "data": {"seed": 0, "step": 12}}
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_launch_train_resumes_and_quantizes(tmp_path, capsys):
    ck = tmp_path / "ck"
    argv = ["--arch", "opt-proxy", "--smoke", "--device", "cpu",
            f"train.ckpt_dir={ck}", "train.global_batch_size=4",
            "train.seq_len=16", "train.ckpt_every=2", "train.log_every=1"]
    out = tlaunch_train.main(argv + ["train.steps=3"])
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    out = tlaunch_train.main(argv + ["train.steps=5"])
    assert [h["step"] for h in out["history"]] == [3, 4]
    assert "restored step 3" in capsys.readouterr().out
    # the trained weights are what launch.quantize starts from
    cfg = tget_config("opt-proxy", smoke=True)
    like = TTS.init_train_state(cfg, "cpu")
    got = tlaunch_quantize.trained_params(
        str(ck), unstack_layers(like.params), torch.device("cpu"))
    want = unstack_layers(out["state"].params)
    assert [k for k, _ in tree_paths(got)] == [k for k, _ in
                                              tree_paths(want)]
    for (k, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        assert torch.equal(a, b.detach()), k
    path, report = tlaunch_quantize.main(
        ["--arch", "opt-proxy", "--smoke", "--device", "cpu", "--out",
         str(tmp_path / "q"), f"train.ckpt_dir={ck}",
         "quant.calib_batches=1", "quant.calib_batch_size=2",
         "quant.calib_seq_len=16"])
    assert "loaded checkpoint step 5" in capsys.readouterr().out
    assert os.path.exists(path) and report.linears


@contextlib.contextmanager
def world_of_one(d):
    """A gloo process group of this process alone (``file://``
    rendezvous), destroyed after."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{d}/rendezvous", rank=0, world_size=1)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("how", ["--mesh", "train(mesh=)", "parallel.data=2",
                                 "parallel.fsdp=false"])
def test_sharded_training_raises_naming_item_17(how, tmp_path):
    """Sharded training and the sharding fields at a world of one:
    ``launch.train --mesh 1,1`` and ``train(mesh=)`` on a 1x1 mesh (a gloo
    group of this process) end bitwise the one-device run, and ``--mesh
    2,1`` raises naming the world's size; ``parallel.data=2`` and
    ``parallel.fsdp=false`` are taken by the one-device launcher and run
    to the end, as in the reference (which reads them only on a mesh)."""
    argv = ["--arch", "opt-proxy", "--smoke", "--device", "cpu",
            "train.steps=2", "train.global_batch_size=4", "train.seq_len=16"]
    ref = tlaunch_train.main(argv + [f"train.ckpt_dir={tmp_path / 'one'}"])
    argv.append(f"train.ckpt_dir={tmp_path / 'run'}")
    if how == "--mesh":
        with world_of_one(tmp_path):
            with pytest.raises(ValueError, match="needs 2 ranks; the world "
                                                 "has 1"):
                tlaunch_train.main(argv + ["--mesh", "2,1"])
            out = tlaunch_train.main(argv + ["--mesh", "1,1"])
    elif how == "train(mesh=)":
        cfg = tget_config("opt-proxy", smoke=True)
        t = cfg.train
        t.steps, t.global_batch_size, t.seq_len = 2, 4, 16
        t.ckpt_dir = str(tmp_path / "run")
        with world_of_one(tmp_path):
            out = ttrain(cfg, TMarkovLM(cfg.model.vocab_size,
                                        seed=cfg.train.seed),
                         device="cpu", mesh=make_host_mesh(1, 1))
    else:
        out = tlaunch_train.main(argv + [how])
    assert Checkpointer(str(tmp_path / "run")).latest_step() == 2
    assert [h["loss"] for h in out["history"]] == \
        [h["loss"] for h in ref["history"]]
    for (k, a), (_, b) in zip(tree_paths(out["state"]),
                              tree_paths(ref["state"])):
        assert torch.equal(a, b), k


def test_example_twin_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_train_small_lm.py"),
         "--device", "cpu", "--steps", "40", "--ckpt", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    last = [ln for ln in out.stdout.splitlines() if "final loss" in ln][0]
    final, first = (float(x) for x in
                    last.replace("(", " ").replace(")", " ").split()
                    if x.replace(".", "").isdigit())
    assert final < first - 1.0, last


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wrapper_calls(dev):
    """Each CUDA wrapper (the kernel's own, past every dispatcher) on
    contiguous CUDA inputs, one float input requiring grad: the check
    comes before any shape check."""
    r = lambda *s: torch.rand(*s, device=dev)  # noqa: E731
    x = r(64, 128).requires_grad_(True)
    u8 = torch.zeros((64, 64), dtype=torch.uint8, device=dev)
    i8 = torch.zeros((1, 16, 2, 64), dtype=torch.int8, device=dev)
    kpos = torch.arange(16, dtype=torch.int32, device=dev)[None]
    return {
        "hessian_accum": lambda: tops.hessian_accum_cuda(x, r(128, 128)),
        "w4a16_matmul": lambda: tops.w4a16_matmul_cuda(
            x, u8, r(64, 1), r(64, 1), 128),
        "gptq_block": lambda: tops.gptq_block_cuda(
            x[None], r(1, 128, 128), bits=4, group_size=128, blocksize=128,
            symmetric=False),
        "rpiq_block": lambda: tops.rpiq_block_cuda(
            x, r(16, 64), r(16, 128), r(128, 128), r(64, 128), r(64, 128),
            bits=4, block_size=128, alpha=0.01, t_max=5, symmetric=False),
        "int8_kv_attention": lambda: tops.int8_kv_attention_cuda(
            r(1, 2, 2, 64).requires_grad_(True), i8, r(1, 16, 2, 1), i8,
            r(1, 16, 2, 1), kpos, 64),
        "quant_pack": lambda: tops.quant_pack_cuda(x, r(64, 1), r(64, 1),
                                                   128),
        "selective_scan": lambda: tops.selective_scan_cuda(
            r(1, 8, 64).requires_grad_(True), r(1, 8, 64), r(1, 8, 16),
            r(1, 8, 16), r(64, 16), r(64), r(1, 64, 16)),
        "selective_scan_bwd": lambda: tops.selective_scan_bwd_cuda(
            r(1, 8, 64), r(1, 8, 64), r(1, 8, 16), r(1, 8, 16),
            r(64, 16).requires_grad_(True), r(64), r(1, 64, 16),
            r(1, 8, 64)),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("op", sorted(tops.kernel_launches()))
def test_gpu_wrappers_refuse_inputs_that_require_grad(cuda, op):
    before = tops.kernel_launches()[op]
    with pytest.raises(NotImplementedError, match="has no backward"):
        _wrapper_calls(cuda)[op]()
    assert tops.kernel_launches()[op] == before


@pytest.mark.gpu
def test_gpu_mamba_train_step_matches_cpu(cuda):
    """falcon-mamba smoke: the card's step runs the scan's forward and
    backward kernels (each layer's forward twice under remat)."""
    tops.reset_kernel_launches()
    check_step_matches_cpu(cuda, "falcon-mamba-7b")
    launches = tops.kernel_launches()
    assert launches["selective_scan_bwd"] == 3           # smoke: 3 layers
    assert launches["selective_scan"] == 6


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu(cuda):
    check_step_matches_cpu(cuda, "opt-proxy")


def check_step_matches_cpu(cuda, arch: str) -> None:
    cfg = tget_config(arch, smoke=True)
    cfg.train.lr, cfg.train.warmup_steps = 3e-3, 2
    batch = TMarkovLM(cfg.model.vocab_size, seed=0).batch(8, 32)
    out = {}
    for dev in ("cpu", cuda):
        st = TTS.init_train_state(cfg, "cpu")
        if dev != "cpu":
            st = TTS.TrainState(*[
                TTS.opt.tree_map(lambda a: a.to(dev), part)
                for part in st])
        step = TTS.make_train_step(cfg)
        st, m = step(st, batch)
        out[str(dev)] = (float(m["loss"]), params_flat(
            TTS.opt.tree_map(lambda a: a.cpu(), st.params)))
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-2 * abs(lc)
    assert tree_rel(pg, pc) <= 1e-2
