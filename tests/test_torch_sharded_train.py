"""Sharded training on ``torch.distributed`` against the single-device
port and the single-device JAX package.

(a) The placements: ``param_pspecs``, ``cache_pspecs``, ``batch_pspecs``
and ``train_state_pspecs`` (fp32 and int8 moments) equal the JAX
package's over every smoke config's param tree, cache tree and TrainState
on meshes (2,2), (4,1), (1,4) and (pod 2, 2, 1), with ``fsdp`` true and
false (JAX's functions read only the mesh's names and sizes: a
``jax.sharding.AbstractMesh`` there, a stand-in here).
(b) The flat wire codec ``enc_int8`` / ``dec_int8`` bitwise JAX's, at
lengths that are no multiple of 256 and on ties.
(c) One gloo world of 4 ranks (``tests/_torch_sharded_train_checks.py``,
one start-up, ``file://`` rendezvous, one thread a rank), beside it JAX's
``gpipe_forward`` in a forced-8-device subprocess and ``launch.train
--mesh 2,1`` under ``torch.distributed.run``:

- ``compress_psum`` over the 4 ranks equals the JAX codec applied rank by
  rank and averaged (means and error-feedback residues ≤ 1e-6) and holds
  the JAX check's bounds over six steps (``tests/_distributed_checks.py
  :88-136``: int8 step error < 0.05, cumulative < 0.02, bf16 cumulative
  < 0.01);
- ``gpipe_forward`` on (pod 2, data 2, model 1), its stages made by
  ``stack_stages``, equals the plain stacked forward and JAX's at rtol
  1e-4 / atol 1e-5 (``:139-163``);
- the sharded step against the single-device port at the training pin,
  loss ≤ 1e-5 and fp32 ≤ 1e-5 relative per leaf. On a ``model`` axis of
  2 or 4 the step computes its share (attention by heads, the MLP by
  ``d_ff``, the embedding, head and loss by vocab; with ``parallel.sp``
  the residual's sequence over the axis). The leaves the data parallel
  reduction's and the row-parallel sums' order moves past the pin are
  recorded in ``PAST_THE_PIN`` and held at the JAX package's own sharded
  pins (rtol 3e-2 / atol 3e-3, ``tests/_distributed_checks.py:46-54``):
  the key biases (self and cross), whose exact gradient is zero (the
  softmax ignores a shift common to every key), so Adam moves them by
  ±lr at the sign of rounding noise (3.5e-5 on 4x1, 2.4e-5 and 2.8e-5
  on 2x2 after two steps, 1.0e-4 after six; under the split 8.0e-5 on
  1x4, 4.2e-5 to 6.2e-5 on 2x2, 2.2e-4 after six; whisper's, every
  element noise, 0.78 to 1.4 relative, at most 3.8e-6 apart); opt-proxy's
  first up-projection bias under ``grad_accum=2`` and the split (7.9e-5
  after two steps), whose smallest gradient element is 4.9e-6 of the
  leaf's largest, so the ~7e-7 the split's sum order moves the gradient
  by is a tenth of that element, which Adam's normalised step carries;
  and
  under int8 moments the parameters of the q, k and up projections,
  where codes flip at ties (≤ 1.2e-4 of a leaf's codes, by one step; the
  parameters 1.8e-4, 1.2e-4, 6.0e-5, 4.3e-5 and 2.5e-5 relative after
  two steps). internlm2-1.8b smoke on 2x2, the JAX check's inputs, is
  held against the single-device JAX step too (loss ≤ 1e-5, params as
  above). olmoe-1b-7b smoke on 2x2 (attention and experts split) with
  local dispatch (its capacity from the local tokens, the load-balance
  loss averaged over the data group) is held at the routed-expert pin,
  1e-2 per leaf, against the single-device port run on each data block
  with the losses averaged, and with ``ep_local_dispatch=false`` (global
  dispatch: every rank runs the whole batch) against the one-device step
  at the same pin; pixtral-12b smoke under ``parallel.sp`` with 8
  frontend embeddings (24 positions, sharded) and, on 1x4, 3 (19
  positions: the residual stays whole, as JAX's guard leaves it); on 4x1
  (no model split) global dispatch is the
  one-device step bitwise; ``parallel.sp`` builds a step on every
  architecture (it once raised naming ROADMAP.md queue 1 item 26 on
  RG-LRU, MLA and the MTP head);
- the split of GQA, Mamba, routed experts, RG-LRU, MLA and the MTP head
  (``sharding.model_split``'s ``gqa``, ``mamba``, ``experts``,
  ``rglru``, ``mla`` and ``mtp``, each unit-tested): internlm2-1.8b
  smoke on 1x4 (4 q-heads over 2 kv-heads: each kv-head read by two
  ranks, its k / v leaves' gradients summed before the cut),
  recurrentgemma-9b smoke on 1x4 (local MQA 4 / 1 split, RG-LRU by its
  channels, u all-gathered for rg / ig) and on 2x2 under
  ``parallel.sp``, falcon-mamba-7b smoke on 1x4, 2x2 and 2x2 under
  ``parallel.sp`` (the [u | z] in projection re-blocked by an
  all-to-all, the x projection all-reduced both ways), deepseek-v3-671b
  smoke cut to its dense layer on 1x4 (MLA by heads, its latents whole,
  the MTP projection by columns, a dense MTP layer) at the training pins
  against the one-device port; internlm2, falcon-mamba, recurrentgemma
  and deepseek on 1x4 against the single-device JAX step too
  (``PAST_THE_PIN_JAX``); olmoe-1b-7b smoke on 1x4 (2 experts a rank)
  and on 2x2 under ``parallel.sp`` with local dispatch, and deepseek
  smoke at its full smoke depth on 2x2 under ``parallel.sp`` (its MTP
  layer routed), at the routed pin; the falcon-mamba, recurrentgemma and
  deepseek 1x4 runs' gathered states restore through the JAX
  ``Checkpointer`` and onto 2x2 and one device bitwise;
- ``train(mesh=)`` on 2x2, stopped by a SIGTERM that only rank 1
  receives, stops every rank at the same step; resumed from its
  checkpoint on 4x1 and on one device, both end at the pins above against
  the uninterrupted one-device run; rank 0 alone writes; the checkpoint
  restores through the JAX ``Checkpointer`` bitwise the ranks' gathered
  state, and the 4x1 run's restores onto 2x2 and onto one device bitwise;
- every rank's outputs are bitwise rank 0's;
- ``launch.train --mesh 2,1`` (2 ranks, ``--device cpu``): rank 0 alone
  writes, its final state holds the pins against the one-process
  launcher's, and its printed loss is the one-process launcher's within
  the print's 1e-4.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import contextlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs.registry import ARCH_IDS
from repro.data import MarkovLM as JMarkovLM
from repro.distributed import sharding as jshd
from repro.distributed.checkpoint import Checkpointer as JCheckpointer
from repro.kernels import kv_codec as jcodec
from repro.models import transformer as JT
from repro.training import optimizer as jopt
from repro.training import train_step as JTS
from repro_torch.configs import get_config as tget_config
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed.checkpoint import Checkpointer, tree_paths
from repro_torch.kernels import kv_codec as tcodec
from repro_torch.launch import train as tlaunch_train
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as TTS
from repro_torch.training.trainer import train as ttrain

import _torch_sharded_train_checks as checks
from test_torch_train_trajectory import port_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4


@contextlib.contextmanager
def one_thread():
    """The ranks' one thread for the single-device references: a CPU
    product's rounding may follow the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) placements
# ---------------------------------------------------------------------------

MESHES = [((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 4), ("data", "model")), ((2, 2, 1), ("pod", "data", "model"))]


def _jax_specs(tree) -> dict:
    """{path: spec entries} of a JAX tree of PartitionSpecs or
    NamedShardings."""
    is_spec = lambda x: isinstance(x, P) or hasattr(x, "spec")  # noqa
    return {jshd._path_str(p): tuple(getattr(s, "spec", s))
            for p, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=is_spec)}


def _port_specs(tree, prefix: str = "") -> dict:
    """{path: spec entries} of a port spec tree (``PSpec`` leaves), named
    as ``tree_paths`` names the values."""
    if isinstance(tree, tshd.PSpec):
        return {prefix: tuple(tree)}
    join = lambda part: f"{prefix}/{part}" if prefix else part  # noqa
    if isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif hasattr(tree, "_fields"):
        kids = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    else:
        kids = [(str(i), v) for i, v in enumerate(tree)]
    out = {}
    for part, child in kids:
        out.update(_port_specs(child, join(part)))
    return out


def _zeros_like_sds(tree):
    """Port tensors (and ``Quantized8`` moments) of a JAX shape tree."""
    def leaf(x):
        if isinstance(x, jopt.Quantized8):
            return topt.Quantized8(torch.zeros(x.q.shape, dtype=torch.int8),
                                   torch.zeros(x.scale.shape))
        return torch.zeros(x.shape)
    return jax.tree_util.tree_map(
        leaf, tree, is_leaf=lambda x: isinstance(x, jopt.Quantized8))


@pytest.fixture(scope="module")
def shape_trees():
    """Per smoke arch: the JAX TrainState's shapes (fp32 and int8
    moments) and a cache tree's, and the port's zero trees of them."""
    out = {}
    for arch in ARCH_IDS:
        jcfg = jget_config(arch, smoke=True)
        mc = jcfg.model
        states = {}
        for int8 in (False, True):
            jcfg.parallel.int8_optimizer_state = int8
            sds = jax.eval_shape(
                lambda: JTS.init_train_state(jcfg, jax.random.PRNGKey(0)))
            conv = _zeros_like_sds(sds)
            states[int8] = (sds, TTS.TrainState(
                conv.params, topt.AdamWState(*conv.opt), conv.step))
        if mc.is_encoder_decoder:
            frames = jax.ShapeDtypeStruct((4, mc.encoder_seq_len,
                                           mc.d_model), jnp.float32)
            tokens = jax.ShapeDtypeStruct((4, 8), jnp.int32)
            caches = jax.eval_shape(
                lambda p, f, t: JT.encdec_prefill_begin(mc, p, f, t, 32)[1],
                states[False][0].params, frames, tokens)
        else:
            caches = jax.eval_shape(lambda: JT.init_block_caches(mc, 4, 32))
        out[arch] = (states, caches, _zeros_like_sds(caches))
    return out


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "nofsdp"])
@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_placements_match_jax(shape, names, fsdp, shape_trees):
    jm = AbstractMesh(shape, names)
    tm = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    for arch, (states, caches, tcaches) in shape_trees.items():
        jr = jshd.make_rules(jm, jget_config(arch, smoke=True).parallel)
        tr = tshd.make_rules(tm, tget_config(arch, smoke=True).parallel)
        assert (tr.dp_axes, tr.tp_axis, tr.dp_size()) == \
            (jr.dp_axes, jr.tp_axis, jr.dp_size())
        for int8, (sds, tstate) in states.items():
            want = _jax_specs(jshd.train_state_shardings(sds, jr, fsdp))
            got = _port_specs(tshd.train_state_pspecs(tstate, tr, fsdp))
            assert got == want, (arch, int8)
        assert _port_specs(tshd.param_pspecs(tstate.params, tr, fsdp)) == \
            _jax_specs(jshd.param_pspecs(sds.params, jr, fsdp)), arch
        assert _port_specs(tshd.cache_pspecs(tcaches, tr)) == \
            _jax_specs(jshd.cache_shardings(caches, jr)), arch
        for b in (1, 2, 3, 4, 8):
            jb = {"tokens": jax.ShapeDtypeStruct((b, 16), jnp.int32),
                  "loss_mask": jax.ShapeDtypeStruct((b, 16), jnp.float32)}
            tb = {k: torch.zeros(v.shape) for k, v in jb.items()}
            assert _port_specs(tshd.batch_pspecs(tb, tr)) == \
                _jax_specs(jshd.batch_shardings(jb, jr)), (arch, b)


# ---------------------------------------------------------------------------
# (b) the flat wire codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 257, 2113, 64 * 33])
def test_wire_codec_bitwise_jax(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * np.exp(rng.randn(n))).astype(np.float32)
    # ties: a block's absmax 127 gives scale 1 + 1e-12 → 1.0 in f32, and
    # halves round to even
    x[: min(n, 256)] = np.resize(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5,
                                           -126.5, 3.5], np.float32),
                                 min(n, 256))
    shape = (n,) if n % 33 else (n // 33, 33)
    x = x.reshape(shape)
    jq, js = jcodec.enc_int8(jnp.asarray(x))
    tq, ts = tcodec.enc_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.shape[1] == tcodec.WIRE_BLOCK == jcodec.WIRE_BLOCK
    jd = jcodec.dec_int8(jq, js, shape)
    td = tcodec.dec_int8(tq, ts, shape)
    assert tuple(td.shape) == shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# (c) one gloo world of four ranks
# ---------------------------------------------------------------------------

# leaves the data parallel reduction's order moves past 1e-5, held at the
# JAX package's sharded pins (module docstring)
PAST_THE_PIN = r"(mixer|xattn)/k/b$|blocks/0/sub0/mlp/up/b$"
# the routed cases under local dispatch over 2 data ranks: held against
# the one-device step on each data block; the cases also held against
# the single-device JAX step
PER_BLOCK = ("moe", "moe22_sp", "ds22_sp")
# against JAX also Mamba's dt bias and the scan leaves' second moments:
# the single-device port is itself 1.38e-5 and 1.07e-5 from the JAX step
# on the dt bias after one and two steps (falcon-mamba smoke; a
# zero-initialised bias, so the leaf is Adam's normalised step, and the
# port's sequential scan sums the gradient in another order than JAX's
# chunked associative scan), and up to 9.2e-6 on the second moments;
# the 1x4 split sums the x projection's fp32 partials over the ranks,
# which moves the scan's gradients by rounding, squared in the second
# moments (up to 9.9e-6 from the one-device port): together 1.75e-5 (x),
# 1.27e-5 (a_log), 1.25e-5 (dt bias) and 1.18e-5 (d_skip)
# ; and recurrentgemma smoke's second layer's norm2 scale, where the
# single-device port is itself 2.01e-5 from the JAX step after two steps
# (its RG-LRU doubling scan multiplies in another order than JAX's
# associative scan) and the 1x4 split 1.83e-5
PAST_THE_PIN_JAX = (PAST_THE_PIN + r"|mixer/dt/b$"
                    r"|\.opt/\.v/.*mixer/(x/w|a_log|d_skip)$"
                    r"|\.params/blocks/0/sub1/norm2/scale$")
JAX_CASES = ("intern", "intern14", "mamba14", "rgemma14", "ds14")
# the cases held at the routed-expert pin (1e-2 per leaf and on the loss)
ROUTED = ("moe", "moe_global", "moe_global41", "moe14", "moe22_sp",
          "ds22_sp")
PAST_THE_PIN_INT8 = r"\.params/.*(mixer/(q|k)|mlp/up)/(w|b)$"

_JAX_GPIPE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax, numpy as np
from repro.distributed.pipeline_parallel import gpipe_forward, make_stage_fn
inp = np.load({inp!r})
ws, x = inp["gpipe/ws"], inp["gpipe/x"]
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
fn = make_stage_fn(lambda w, h: jax.numpy.tanh(h @ w), per_stage=2)
with mesh:
    y = gpipe_forward(mesh, fn, ws.reshape(2, 2, *ws.shape[1:]), x,
                      n_microbatches=4, axis="pod")
np.save({out!r}, np.asarray(y))
"""


def _launch_argv(ckpt: str) -> list:
    return ["--arch", "opt-proxy", "--smoke", "--device", "cpu",
            f"train.ckpt_dir={ckpt}", "train.steps=4",
            "train.global_batch_size=8", "train.seq_len=16",
            "model.dtype=float32", "train.ckpt_async=false"]


def _start(argvs):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen(a, cwd=str(ROOT), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for a in argvs]


def _finish(procs, timeout):
    """Wait for every process; all must exit 0 (a failed one kills the
    rest)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
            if p.returncode != 0:
                raise AssertionError(f"exit {p.returncode}:\n{outs[-1]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _jax_state(name):
    jcfg = jget_config(checks.CASES[name][0], smoke=True)
    jcfg.model.dtype = "float32"
    for key, v in checks.CASES[name][3].items():
        if key.startswith("model."):
            setattr(jcfg.model, key.split(".")[1], v)
    tcfg = checks.case_config(name)
    jcfg.parallel.int8_optimizer_state = tcfg.parallel.int8_optimizer_state
    jcfg.train.grad_accum = tcfg.train.grad_accum
    return jcfg, tcfg, JTS.init_train_state(jcfg, jax.random.PRNGKey(0))


def _batches(name, tcfg):
    """The case's global batches (numpy, from seeds)."""
    _, _, steps, _ = checks.CASES[name]
    if name in ("intern", "intern14"):       # the JAX check's inputs
        b = JMarkovLM(tcfg.model.vocab_size, seed=1).batch(4, 16)
        return [{"tokens": np.asarray(b["tokens"]).astype(np.int64)}]
    rows = 4 if name.startswith(("moe", "ds")) else 8
    out = []
    for i in range(steps):
        b = {"tokens": TMarkovLM(tcfg.model.vocab_size, seed=10 + i).batch(
            rows, 16)["tokens"].numpy()}
        if name == "accum":
            # each data rank's block of each microbatch keeps another share
            keep = np.linspace(0.15, 0.95, rows)[:, None]
            b["loss_mask"] = (np.random.RandomState(i).rand(rows, 16)
                              < keep).astype(np.float32)
        if tcfg.model.is_encoder_decoder:
            b["frames"] = np.random.RandomState(20 + i).randn(
                rows, tcfg.model.encoder_seq_len,
                tcfg.model.d_model).astype(np.float32)
        if name.startswith("pixtral"):
            f = 8 if name == "pixtral_sp" else 3
            b["embeds"] = (np.random.RandomState(30 + i).randn(
                rows, f, tcfg.model.d_model) * 0.02).astype(np.float32)
        out.append(b)
    return out


def _arrays(prefix, tree):
    return {f"{prefix}/{k}": v.detach().cpu().numpy()
            for k, v in tree_paths(tree)}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _per_block_step(tcfg, state, batch, dp=2):
    """The single-device port's step on the mean of each data block's
    loss: the sharded step's semantics under local MoE dispatch."""
    rows = batch["tokens"].shape[0] // dp
    grads, losses = None, []
    for r in range(dp):
        blk = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
        g, m = TTS.loss_and_grads(tcfg, state.params, blk)
        losses.append(float(m["loss"]))
        grads = g if grads is None else topt.tree_map(torch.add, grads, g)
    grads = topt.tree_map(lambda g: g / torch.full_like(g, dp), grads)
    grads, _ = topt.clip_by_global_norm(grads, tcfg.train.grad_clip)
    lr = TTS.learning_rate(tcfg.train, state.step)
    params, ost = topt.adamw_update(grads, state.opt, state.params, lr=lr,
                                    tc=tcfg.train)
    return TTS.TrainState(params, ost, state.step + 1), sum(losses) / dp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    inp, want = {}, {"cases": {}}
    rng = np.random.RandomState(0)
    inp["compress/g"] = rng.randn(WORLD, 64, 33).astype(np.float32)
    inp["gpipe/ws"] = (rng.randn(4, 32, 32) * 32 ** -0.5).astype(np.float32)
    inp["gpipe/x"] = rng.randn(8, 32).astype(np.float32)
    states = {}
    for name in checks.CASES:
        jcfg, tcfg, jst = _jax_state(name)
        tst = port_state(tcfg, jst)
        states[name] = (jcfg, tcfg, jst, tst)
        inp.update(_arrays(f"{name}/state", tst))
        for i, b in enumerate(_batches(name, tcfg)):
            for k, v in b.items():
                inp[f"{name}/batch/{i}/{k}"] = v
    np.savez(d / "inputs.npz", **inp)
    helper = str(ROOT / "tests" / "_torch_sharded_train_checks.py")
    procs = _start(
        [[sys.executable, helper, str(r), str(WORLD), str(d)]
         for r in range(WORLD)]
        + [[sys.executable, "-c", _JAX_GPIPE.format(
            src=str(ROOT / "src"), inp=str(d / "inputs.npz"),
            out=str(d / "jax_gpipe.npy"))]]
        + [[sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", helper, "launcher", str(d / "lsaves")]
           + _launch_argv(str(d / "lck")) + ["--mesh", "2,1"]])
    try:
        with one_thread():
            for name, (jcfg, tcfg, jst, tst) in states.items():
                batches = [_tbatch(b) for b in _batches(name, tcfg)]
                if name in PER_BLOCK:
                    ref, loss = _per_block_step(tcfg, tst, batches[0])
                    want["cases"][name] = (ref, [loss])
                    continue
                step, losses = TTS.make_train_step(tcfg), []
                for b in batches:
                    tst, m = step(tst, b)
                    losses.append(float(m["loss"]))
                want["cases"][name] = (tst, losses)
            for name in JAX_CASES:
                jcfg, tcfg, jst, _ = states[name]
                jstep, losses = jax.jit(JTS.make_train_step(jcfg)), []
                for b in _batches(name, tcfg):
                    jst, jm = jstep(jst, {"tokens": jnp.asarray(
                        b["tokens"], jnp.int32)})
                    losses.append(float(jm["loss"]))
                want[f"jax/{name}"] = (port_state(tcfg, jst), losses)
            # the uninterrupted one-device train(), and the one-process
            # launcher
            ref = ttrain(checks.train_config(str(d / "ref")),
                         TMarkovLM(128, seed=0), device="cpu", verbose=False)
            want["train"] = ref
            want["launch"] = tlaunch_train.main(_launch_argv(str(d / "one")))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    outs = _finish(procs, timeout=400)
    # the one-device resume from a copy of the 2x2 run's checkpoint
    shutil.copytree(d / "ck_22", d / "one_resume")
    with one_thread():
        want["resumed_one"] = ttrain(
            checks.train_config(str(d / "one_resume")),
            TMarkovLM(128, seed=0), device="cpu", verbose=False)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    metas = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return dict(d=d, want=want, ranks=ranks, metas=metas, states=states,
                launcher_out=outs[-1], jax_gpipe=np.load(d / "jax_gpipe.npy"))


def _flat(arrays: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def _tflat(tree) -> dict:
    return {k: v.detach().numpy() for k, v in tree_paths(tree)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def assert_state_pins(got: dict, want: dict, past: str):
    """Every float leaf ≤ 1e-5 relative; a leaf matching ``past`` (the
    recorded ones) at the JAX sharded pins instead; int8 codes may differ
    by one step at ties (≤ 1e-3 of them), scales at the JAX pins."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if g.dtype == np.int8:
            off = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert off.max() <= 1 and (off > 0).mean() <= 1e-3, k
        elif _rel(g, w) > 1e-5:
            assert past and re.search(past, k), (k, _rel(g, w))
            np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-3,
                                       err_msg=k)


def test_every_rank_bitwise_rank0(world):
    r0 = world["ranks"][0]
    for r, got in enumerate(world["ranks"][1:], 1):
        assert got.keys() == r0.keys()
        for k, v in r0.items():
            if k.startswith("compress/") and k.endswith("/err"):
                continue     # each rank's own residue
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")
        assert world["metas"][r] == world["metas"][0]


def _jax_compress(g, method, steps):
    """JAX's codec applied rank by rank with its error feedback; the means
    in f32."""
    n = g.shape[0]
    err = np.zeros_like(g)
    out = []
    for s in range(steps):
        gs = (g * np.float32(1.0 + 0.3 * s)).astype(np.float32)
        if method == "none":
            out.append((gs.sum(0) / np.float32(n), None))
            continue
        recon = np.empty_like(gs)
        for r in range(n):
            gf = gs[r] + err[r]
            if method == "bf16":
                recon[r] = np.asarray(jnp.asarray(gf).astype(
                    jnp.bfloat16).astype(jnp.float32))
            else:
                q, sc = jcodec.enc_int8(jnp.asarray(gf))
                recon[r] = np.asarray(jcodec.dec_int8(q, sc, gf.shape))
            err[r] = gf - recon[r]
        out.append((recon.sum(0) / np.float32(n), err.copy()))
    return out


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compress_psum_matches_jax_codec(world, method):
    g = np.load(world["d"] / "inputs.npz")["compress/g"]
    want = _jax_compress(g, method, checks.COMPRESS_STEPS)
    for r, got in enumerate(world["ranks"]):
        for s, (red, err) in enumerate(want):
            np.testing.assert_allclose(got[f"compress/{method}/{s}/red"],
                                       red, rtol=0, atol=1e-6)
            if err is not None:
                np.testing.assert_allclose(got[f"compress/{method}/{s}/err"],
                                           err[r], rtol=0, atol=1e-6)


def test_compress_psum_holds_the_jax_bounds(world):
    g = np.load(world["d"] / "inputs.npz")["compress/g"]
    got = world["ranks"][0]

    def errors(method):
        errs, acc_t, acc_c = [], 0.0, 0.0
        for s in range(checks.COMPRESS_STEPS):
            true = (g * np.float32(1.0 + 0.3 * s)).mean(0)
            red = got[f"compress/{method}/{s}/red"]
            acc_t, acc_c = acc_t + true, acc_c + red
            errs.append(np.linalg.norm(red - true) / np.linalg.norm(true))
        return errs, np.linalg.norm(acc_c - acc_t) / np.linalg.norm(acc_t)

    errs8, cum8 = errors("int8")
    assert errs8[0] < 0.05 and cum8 < 0.02, (errs8, cum8)
    assert errors("bf16")[1] < 0.01
    assert errors("none")[1] < 1e-6


def test_gpipe_matches_stacked_forward_and_jax(world):
    inp = np.load(world["d"] / "inputs.npz")
    ws, x = torch.from_numpy(inp["gpipe/ws"]), torch.from_numpy(inp["gpipe/x"])
    ref = x
    for w in ws:
        ref = torch.tanh(ref @ w)
    got = world["ranks"][0]["gpipe/y"]
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, world["jax_gpipe"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", [n for n in checks.CASES
                                  if n not in ROUTED])
def test_sharded_step_matches_single_device(world, name):
    ref, losses = world["want"]["cases"][name]
    got = _flat(world["ranks"][0], f"{name}/out")
    past = PAST_THE_PIN_INT8 if "int8" in name else PAST_THE_PIN
    assert_state_pins(got, _tflat(ref), past)
    for m, want in zip(world["metas"][0][name], losses):
        assert abs(m["loss"] - want) <= 1e-5 * abs(want), (m, want)


@pytest.mark.parametrize("name", list(checks.CASES))
def test_split_products_run_at_local_widths(world, name):
    """Each case's o, down and (Mamba's, RG-LRU's) out products take the
    rank's heads, ``d_ff`` columns, ``d_inner`` and ``lru_width``
    channels where the plan splits them (the heads and kv-heads divide
    the ``model`` axis, or the heads do and the axis is a multiple of the
    kv-heads, or, MLA, the heads do; ``d_ff``; ``d_inner``;
    ``lru_width``), a shared expert's down its width / m where the
    experts split, and deepseek's MTP projection gives d/m columns."""
    mc = checks.case_config(name).model
    m = checks.CASES[name][1][1]
    h, kv = mc.num_heads, mc.num_kv_heads
    split = h % m == 0 and (mc.mla.enabled or kv % m == 0 or m % kv == 0)
    heads = h // m if split else h
    hd = mc.mla.v_head_dim if mc.mla.enabled else mc.head_dim

    def cut(n):
        return n // m if n % m == 0 else n
    e = mc.moe
    shared = e.d_ff_expert * e.num_shared_experts
    want = {".o": [heads * hd], ".down": [cut(mc.d_ff)],
            "shared.down": [shared // m if e.num_experts % m == 0
                            and shared % m == 0 else shared],
            ":out": [cut(mc.d_model)]}
    if "mamba" in mc.layer_kinds:
        want[".out"] = [cut(mc.d_inner)]
    if "rglru" in mc.layer_kinds:
        want[".out"] = [cut(mc.rglru.lru_width)]
    got = world["metas"][0][f"{name}/widths"]
    assert got, name
    assert ("mtp.proj:out" in got) == (mc.mtp_depth > 0), got
    for layer, widths in got.items():
        key = ("shared.down" if layer.endswith("shared.down")
               else layer[max(layer.rfind("."), layer.rfind(":")):])
        assert widths == want[key], (layer, widths)


def test_sharded_step_matches_jax(world):
    jst1, (jloss,) = world["want"]["jax/intern"]
    got = _flat(world["ranks"][0], "intern/out")
    assert abs(world["metas"][0]["intern"][0]["loss"] - jloss) <= \
        1e-5 * abs(jloss)
    assert_state_pins(got, _tflat(jst1), PAST_THE_PIN)


@pytest.mark.parametrize("name", ["intern14", "mamba14", "rgemma14",
                                  "ds14"])
def test_split_step_matches_jax(world, name):
    """internlm2-1.8b smoke on 1x4 (each kv-head read by two ranks),
    falcon-mamba-7b smoke on 1x4 (32 of 128 channels a rank, [u | z]
    re-blocked), recurrentgemma-9b smoke on 1x4 (16 of 64 RG-LRU
    channels a rank) and deepseek-v3-671b smoke cut to its dense layer on
    1x4 (1 MLA head a rank, the MTP projection at 16 of 64 columns)
    against the single-device JAX step: the losses at 1e-5, the state at
    the training pins (``PAST_THE_PIN_JAX``: Mamba's dt bias and the scan
    leaves' second moments, where the one-device port already differs
    from JAX by up to 1.38e-5, and one recurrentgemma norm scale, 2.01e-5
    on one device)."""
    jst, jlosses = world["want"][f"jax/{name}"]
    got = _flat(world["ranks"][0], f"{name}/out")
    for m, want in zip(world["metas"][0][name], jlosses):
        assert abs(m["loss"] - want) <= 1e-5 * abs(want), (m, want)
    assert_state_pins(got, _tflat(jst), PAST_THE_PIN_JAX)


def test_split_mamba_checkpoint_restores_bitwise(world):
    """The falcon-mamba 1x4 run's gathered state, checkpointed by rank 0,
    restores through the JAX ``Checkpointer`` bitwise (the stored [u | z]
    layout is the JAX rule's: the exchange happens inside the step), and
    onto 2x2 and onto one device bitwise."""
    _restores_bitwise(world, "mamba14")


@pytest.mark.parametrize("name", ["rgemma14", "ds14"])
def test_split_checkpoint_restores_bitwise(world, name):
    """The recurrentgemma 1x4 run's gathered state (its RG-LRU split by
    channels) and deepseek's (MLA by heads, the MTP projection by
    columns), checkpointed by rank 0, restore through the JAX
    ``Checkpointer``, onto 2x2 and onto one device bitwise: the stored
    blocks are the JAX rules' own."""
    _restores_bitwise(world, name)


def _restores_bitwise(world, name):
    d, r0 = world["d"], world["ranks"][0]
    got = _flat(r0, f"{name}/out")
    jcfg, tcfg, jst, _ = world["states"][name]
    jrest, extra = JCheckpointer(str(d / f"ck_{name}")).restore(jst)
    assert extra["step"] == checks.CASES[name][2]
    jflat = {jshd._path_str(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(jrest)}
    one, _ = Checkpointer(str(d / f"ck_{name}")).restore(
        TTS.init_train_state(tcfg, "cpu"))
    one = _tflat(one)
    onto22 = _flat(r0, f"{name}/restored22")
    assert jflat.keys() == got.keys() == one.keys() == onto22.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)
        np.testing.assert_array_equal(one[k], v, err_msg=k)
        np.testing.assert_array_equal(onto22[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["moe14", "moe22_sp", "ds22_sp"])
def test_routed_experts_split_at_the_routed_pin(world, name):
    """olmoe-1b-7b smoke with its experts split over ``model`` (the
    routing whole on every rank): on 1x4, 2 of 8 experts a rank, against
    the one-device step; on 2x2 under ``parallel.sp`` with local
    dispatch against the per-block one-device step; deepseek-v3-671b
    smoke at its full smoke depth on 2x2 under ``parallel.sp`` (2 MLA
    heads and 4 experts a rank, its MTP layer routed) against the
    per-block one-device step. All at the routed-expert pin, 1e-2 per
    leaf and on the loss."""
    _routed_pin(world, name)


def _routed_pin(world, name):
    ref, (loss,) = world["want"]["cases"][name]
    got = _flat(world["ranks"][0], f"{name}/out")
    want = _tflat(ref)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _rel(got[k], w) <= 1e-2, (k, _rel(got[k], w))
    m = world["metas"][0][name][0]
    assert abs(m["loss"] - loss) <= 1e-2 * abs(loss), (m["loss"], loss)


def test_routed_moe_local_dispatch_per_block(world):
    """2x2, the attention and the experts split over ``model``: local
    dispatch against the per-block one-device step at the routed-expert
    pin."""
    _routed_pin(world, "moe")


def test_routed_moe_global_dispatch_split_at_the_routed_pin(world):
    """2x2 under global dispatch: every rank runs the whole batch, the
    attention and the experts split over ``model``. Against the
    one-device step: the loss and the parameters at the dense pins (no
    token changes its experts: the loss is the one device's); the
    moments at the routed-expert pin, 1e-2 per leaf. The experts' bf16
    products round the split's fp32 sum-order change into bf16 steps of
    the gradient (the moments ~1e-3 off, 3.3e-3 at most, the parameters
    within 1e-5, on the CPU)."""
    ref, (loss,) = world["want"]["cases"]["moe_global"]
    got, want = _flat(world["ranks"][0], "moe_global/out"), _tflat(ref)
    moments = [k for k in want if k.startswith(".opt/")]
    assert moments
    for k in moments:
        assert _rel(got.pop(k), want.pop(k)) <= 1e-2, k
    assert_state_pins(got, want, PAST_THE_PIN)
    m = world["metas"][0]["moe_global"][0]
    assert abs(m["loss"] - loss) <= 1e-5 * abs(loss), (m["loss"], loss)


def test_routed_moe_global_dispatch_is_one_device(world):
    """Under ``ep_local_dispatch=false`` (the reference's global dispatch)
    every rank runs the whole batch: on 4x1, where no product is split
    over ``model``, the step is the one-device step, bitwise."""
    ref, (loss,) = world["want"]["cases"]["moe_global41"]
    got = _flat(world["ranks"][0], "moe_global41/out")
    want = _tflat(ref)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert world["metas"][0]["moe_global41"][0]["loss"] == loss


def _mesh22():
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))


def test_sequence_parallel_raises_naming_item_25():
    """``parallel.sp`` once raised naming item 25: on a covered
    architecture it now builds a sharded step whose plan shards the
    sequence (the gloo world's ``sp`` cases run it) and nothing names
    that item."""
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    cfg = tget_config("opt-proxy", smoke=True)
    cfg.parallel.sp = True
    state = TTS.init_train_state(cfg, "cpu")
    with fake_world(4):
        rules = tshd.make_rules(make_host_mesh(data=2, model=2),
                                cfg.parallel)
        specs = tshd.train_state_pspecs(state, rules)
        assert callable(TTS.make_sharded_train_step(cfg, rules, specs))
        plan = tshd.model_split(cfg.model, rules)
        assert plan.sp and plan.seq_split(16) and not plan.seq_split(15)
        assert (plan.attn, plan.mlp, plan.vocab) == (True, True, True)
        assert (plan.cfg.num_heads, plan.cfg.d_ff) == (2, 128)


def test_remat_recompute_reads_the_plan_on_another_thread():
    """autograd runs a CUDA tensor's backward on a thread of its own and
    recomputes a remat'd super-block there: the recomputed forward reads
    the same rules and plan as the forward did."""
    seen, errors = [], []

    def block(x):
        seen.append((tshd.current_rules(), tshd.current_split()))
        return torch.sin(x)

    def backward(y):
        try:
            y.sum().backward()
        except Exception as e:      # noqa: BLE001  (re-raised below)
            errors.append(e)

    rules, plan = object(), object()
    x = torch.ones(3, requires_grad=True)
    with tshd.use_rules(rules), tshd.use_split(plan):
        y = torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
        t = threading.Thread(target=backward, args=(y,))
        t.start()
        t.join()
    assert not errors, errors
    assert seen == [(rules, plan)] * 2
    assert (tshd.current_rules(), tshd.current_split()) == (None, None)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "deepseek-v3-671b"])
def test_sequence_parallel_raises_naming_item_26(arch):
    """``parallel.sp`` once raised naming item 26 on RG-LRU, MLA and
    deepseek's MTP head: the ``model`` axis now splits every layer kind,
    so on each of the four archs the sp step builds and its plan shards
    the sequence and splits the arch's own kind (routed experts, Mamba,
    RG-LRU, MLA with the MTP projection); the gloo world's
    ``moe22_sp``, ``mamba22_sp``, ``rgemma22_sp`` and ``ds22_sp`` run it.
    ``config.refuse_sharding`` is gone."""
    import repro_torch.config as tconfig
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    cfg = tget_config(arch, smoke=True)
    cfg.parallel.sp = True
    state = TTS.init_train_state(cfg, "cpu")
    with fake_world(4):
        rules = tshd.make_rules(make_host_mesh(data=2, model=2),
                                cfg.parallel)
        specs = tshd.train_state_pspecs(state, rules)
        assert callable(TTS.make_sharded_train_step(cfg, rules, specs))
        plan = tshd.model_split(cfg.model, rules)
    assert plan.sp and plan.seq_split(16)
    kind = {"olmoe-1b-7b": "experts", "falcon-mamba-7b": "mamba",
            "recurrentgemma-9b": "rglru", "deepseek-v3-671b": "mla"}[arch]
    assert getattr(plan, kind)
    assert plan.mtp == (arch == "deepseek-v3-671b")
    assert not hasattr(tconfig, "refuse_sharding")


@pytest.mark.parametrize("heads,kv,m,want", [
    (16, 8, 16, {"gqa": True, "q": (1, 1), "kv_of": [r // 2
                                                   for r in range(16)]}),
    (16, 1, 2, {"gqa": True, "q": (8, 1), "kv_of": [0, 0]}),
    (32, 8, 16, {"gqa": True, "q": (2, 1), "kv_of": [r // 2
                                                   for r in range(16)]}),
    (36, 36, 16, {"gqa": False, "q": (36, 36), "kv_of": None}),
    (16, 1, 16, {"kind": "rglru", "width": 4096}),
    (16, 1, 16, {"kind": "rglru", "width": 4104}),
    (128, 128, 16, {"kind": "mla", "d_model": 7168}),
    (12, 12, 16, {"kind": "mla", "d_model": 7168}),
], ids=["16-8-m16", "16-1-m2", "32-8-m16", "36-36-m16-whole",
        "rglru-4096-m16", "rglru-4104-m16-whole", "mla-128-m16",
        "mla-12-m16-whole"])
def test_model_split_flags(heads, kv, m, want):
    """``model_split``'s flags: ``gqa`` where the q-heads divide
    the axis, the kv-heads do not and the axis is a multiple of them
    (rank r keeps q-heads ``[r·H/m, (r+1)·H/m)``, all of kv-head
    ``r·kv // m``), whole otherwise (minicpm's 36 heads on 16); ``mamba``
    where ``d_inner`` divides the axis; ``experts`` where E does;
    ``rglru`` where ``lru_width`` does (recurrentgemma-9b's 4096 on 16:
    256 channels a rank), never reaching Mamba's [u | z] re-blocking;
    ``mla`` where the heads do (deepseek-v3-671b's 128 on 16: 8 a rank),
    with ``mtp`` where ``d_model`` does. Each flag is set by its own
    condition alone."""
    if "kind" in want:
        _kind_flags(heads, kv, m, want)
        return
    import dataclasses
    from repro_torch.config import ModelConfig, MoEConfig, SSMConfig
    base = ModelConfig(num_heads=heads, num_kv_heads=kv,
                       d_model=heads * 8, d_ff=64 * m)
    rules = _rules_1xm(m)
    plans = []
    for r in range(m):
        ag = tshd.AxisGroup(None, m, r, tuple(range(m)))
        with patched_axis_group(ag):
            plans.append(tshd.model_split(base, rules))
    p0 = plans[0]
    assert (p0.gqa, p0.attn) == (want["gqa"], False)
    assert (p0.cfg.num_heads, p0.cfg.num_kv_heads) == want["q"]
    assert not (p0.mamba or p0.experts)
    if want["kv_of"] is not None:
        hd = base.head_dim
        for r, plan in enumerate(plans):
            p = {n: {"w": torch.arange(kv * hd, dtype=torch.float32)
                     .expand(3, -1)} for n in ("k", "v")}
            with patched_copy():
                cut = plan.kv_share(p)
            assert int(cut["k"]["w"][0, 0]) == want["kv_of"][r] * hd
            assert cut["v"]["w"].shape == (3, hd)
            # q-heads [r·H/m, (r+1)·H/m) all belong to that kv-head
            per_kv = heads // kv
            q0 = r * (heads // m)
            assert {q // per_kv for q in range(q0, q0 + heads // m)} == \
                {want["kv_of"][r]}
    # Mamba by d_inner, experts by E: each alone
    mam = dataclasses.replace(base, block_pattern=("mamba",),
                              ssm=SSMConfig(expand=2))
    with patched_axis_group(tshd.AxisGroup(None, m, 0, tuple(range(m)))):
        pm = tshd.model_split(mam, rules)
        assert pm.mamba and pm.cfg.d_inner == mam.d_inner // m
        assert not pm.experts
        odd = dataclasses.replace(mam, ssm=SSMConfig(expand=2, d_inner=m + 1))
        assert not tshd.model_split(odd, rules).mamba
        moe = dataclasses.replace(base, moe=MoEConfig(
            num_experts=2 * m, top_k=2, d_ff_expert=8))
        pe = tshd.model_split(moe, rules)
        assert pe.experts and pe.cfg.moe.num_experts == 2
        assert not pe.mamba and pe.gqa == p0.gqa
        few = dataclasses.replace(moe, moe=MoEConfig(
            num_experts=m + 1, top_k=2, d_ff_expert=8))
        assert not tshd.model_split(few, rules).experts


def _rules_1xm(m):
    names = ("data", "model")
    return tshd.Rules(mesh=types.SimpleNamespace(mesh_dim_names=names,
                                                 shape=(1, m)),
                      dp_axes=("data",))


def _kind_flags(heads, kv, m, want):
    """``test_model_split_flags``' RG-LRU and MLA ids: the flag, the local
    width, the leaves it splits, and the whole layer where the width
    does not divide the axis."""
    from repro_torch.config import MLAConfig, ModelConfig, RGLRUConfig
    if want["kind"] == "rglru":
        w = want["width"]
        mc = ModelConfig(num_heads=heads, num_kv_heads=kv, d_model=4096,
                         d_ff=12288, num_layers=3,
                         block_pattern=("rglru", "rglru", "local"),
                         rglru=RGLRUConfig(enabled=True, lru_width=w))
        leaves = ["blocks/0/sub0/mixer/" + n for n in (
            "in/w", "gate/w", "rg/w", "ig/w", "rg/b", "ig/b", "out/w",
            "conv/w", "conv/b", "lambda")]
    else:
        mc = ModelConfig(num_heads=heads, num_kv_heads=kv,
                         d_model=want["d_model"], d_ff=18432, mtp_depth=1,
                         mla=MLAConfig(enabled=True))
        leaves = [f"{p}mixer/{n}/w" for p in ("blocks/0/sub0/",
                                               "mtp/layer/")
                  for n in ("q_up", "k_up", "v_up", "o")]
    with patched_axis_group(tshd.AxisGroup(None, m, 0, tuple(range(m)))):
        plan = tshd.model_split(mc, _rules_1xm(m))
    kind = want["kind"]
    split = (w if kind == "rglru" else heads) % m == 0
    assert getattr(plan, kind) == split
    assert not (plan.mamba or plan.experts or plan.attn)
    if kind == "rglru":
        assert plan.gqa and not plan.mla
        assert plan.cfg.rglru.lru_width == (w // m if split else w)
        assert mc.rglru.lru_width == w
    else:
        assert not (plan.gqa or plan.rglru)
        assert plan.cfg.num_heads == (heads // m if split else heads)
        assert plan.mtp and plan.splits("mtp/proj/w")
        for whole in ("q_down", "kv_down", "k_rope"):
            assert not plan.splits(f"blocks/0/sub0/mixer/{whole}/w")
    assert all(plan.splits(p) == split for p in leaves), leaves


@contextlib.contextmanager
def patched_axis_group(ag):
    """``sharding.axis_group`` giving ``ag`` (no process group)."""
    orig = tshd.axis_group
    tshd.axis_group = lambda mesh, axis: ag
    try:
        yield
    finally:
        tshd.axis_group = orig


@contextlib.contextmanager
def patched_copy():
    """``copy_all_to_model`` as the identity (no process group)."""
    orig = tshd.copy_all_to_model
    tshd.copy_all_to_model = lambda group, *xs: xs
    try:
        yield
    finally:
        tshd.copy_all_to_model = orig


def _saves(d, prefix):
    return {r: (d / f"{prefix}.{r}").read_text().split()
            for r in range(WORLD) if (d / f"{prefix}.{r}").exists()}


def test_train_mesh_stops_together_and_resumes(world):
    stopped = [m["stopped"] for m in world["metas"]]
    assert len(set(stopped)) == 1 and 0 < stopped[0] < checks.TRAIN_STEPS
    meta = world["metas"][0]
    assert meta["resumed_steps"] == list(range(stopped[0],
                                               checks.TRAIN_STEPS))
    saves = _saves(world["d"], "saves")
    assert list(saves) == [0], saves        # rank 0 alone writes
    assert saves[0] == [str(stopped[0]), str(checks.TRAIN_STEPS)]
    assert meta["restored_step"] == checks.TRAIN_STEPS
    want = _tflat(world["want"]["train"]["state"])
    assert_state_pins(_flat(world["ranks"][0], "train/resumed"), want,
                      PAST_THE_PIN)
    assert_state_pins(_tflat(world["want"]["resumed_one"]["state"]), want,
                      PAST_THE_PIN)
    for h, loss in zip(world["want"]["train"]["history"][stopped[0]:],
                       meta["resumed_loss"]):
        assert abs(h["loss"] - loss) <= 1e-5 * abs(h["loss"])


def test_train_mesh_checkpoints_restore_bitwise(world):
    d, r0 = world["d"], world["ranks"][0]
    stopped = _flat(r0, "train/stopped")
    # the 2x2 run's checkpoint through the JAX Checkpointer
    jcfg = jget_config("opt-proxy", smoke=True)
    like = JTS.init_train_state(jcfg, jax.random.PRNGKey(0))
    jst, extra = JCheckpointer(str(d / "ck_22")).restore(like)
    assert extra["step"] == world["metas"][0]["stopped"]
    got = {jshd._path_str(p): np.asarray(v)
           for p, v in jax.tree_util.tree_leaves_with_path(jst)}
    assert got.keys() == stopped.keys()
    for k, v in stopped.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the 4x1 run's checkpoint onto 2x2 and onto one device
    resumed = _flat(r0, "train/resumed")
    onto22 = _flat(r0, "train/restored22")
    cfg = checks.train_config(str(d / "ck_41"))
    one, _ = Checkpointer(str(d / "ck_41")).restore(
        TTS.init_train_state(cfg, "cpu"))
    one = _tflat(one)
    assert onto22.keys() == resumed.keys() == one.keys()
    for k, v in resumed.items():
        np.testing.assert_array_equal(onto22[k], v, err_msg=k)
        np.testing.assert_array_equal(one[k], v, err_msg=k)


def test_launch_train_mesh_matches_one_process(world):
    d = world["d"]
    saves = {r: (d / f"lsaves.{r}").read_text().split()
             for r in range(2) if (d / f"lsaves.{r}").exists()}
    assert list(saves) == [0] and saves[0] == ["4"], saves
    done = [ln for ln in world["launcher_out"].splitlines()
            if ln.startswith("done:")]
    assert len(done) == 1, world["launcher_out"]
    one = world["want"]["launch"]
    loss = float(done[0].split("loss=")[1])
    assert abs(loss - one["history"][-1]["loss"]) <= 1e-4
    cfg = checks.train_config(str(d / "lck"))
    mesh_state, _ = Checkpointer(str(d / "lck")).restore(
        TTS.init_train_state(cfg, "cpu"))
    assert_state_pins(_tflat(mesh_state), _tflat(one["state"]),
                      PAST_THE_PIN)
