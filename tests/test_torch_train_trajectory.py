"""Five train steps of the port against the JAX package's
``make_train_step`` (jitted), from the same converted state on the same
batches, on the seven architectures of tests/test_torch_training.py, at
model dtype float32, with fp32 AdamW moments (this file) and with int8
moments (tests/test_torch_train_int8.py).

Free-running (each package steps its own state): each step's loss
≤ 1e-4 relative and the final parameters ≤ 1e-4 relative over the whole
tree. Per leaf the parameters are not held: Adam moves a leaf whose exact
gradient is zero (whisper's key biases) by ±lr a step, the sign set by
rounding noise.

Teacher-forced (the port's step applied to JAX's state before each of the
five steps, its result held against JAX's state after it): the routed
models (olmoe, deepseek), whose experts compute in bf16 in both packages
and which JAX's compiled step rounds otherwise than an op-by-op run
(tests/test_torch_training.py); free-running, a routing decision flips
on that difference after a step or two (olmoe's loss 5.6e-3 apart by step
3). Each step's loss ≤ 1e-3 and the parameters after it ≤ 1e-3 over the
whole tree.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro.training import train_step as JTS
from repro_torch.convert import tree_from_numpy
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as TTS

from test_torch_training import (ARCHS, ROUTED, configs, flat, jax_batch,
                                 make_batch, np_tree, torch_batch)

STEPS = 5


def port_state(tcfg, jst):
    """A JAX TrainState (moments f32 or ``Quantized8``) as the port's."""
    def moments(tree):
        def leaf(z):
            if isinstance(z, jopt.Quantized8):
                return topt.Quantized8(torch.from_numpy(np.array(z.q)),
                                       torch.from_numpy(np.array(z.scale)))
            return torch.from_numpy(np.array(z))
        return jax.tree_util.tree_map(
            leaf, tree, is_leaf=lambda x: isinstance(x, jopt.Quantized8))
    step = lambda s: torch.tensor(int(s), dtype=torch.int32)  # noqa: E731
    return TTS.TrainState(
        tree_from_numpy(np_tree(jst.params)),
        topt.AdamWState(step(jst.opt.step), moments(jst.opt.m),
                        moments(jst.opt.v)), step(jst.step))


def tree_rel(got, want) -> float:
    got, want = flat(got), flat(want)
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k] ** 2)) for k in want)
    return float(np.sqrt(num / den))


def run(arch: str, int8: bool, forced: bool):
    """The per-step losses of both packages and the per-step whole-tree
    parameter gaps (after each step)."""
    jcfg, tcfg = configs(arch)
    for c in (jcfg, tcfg):
        c.parallel.int8_optimizer_state = int8
        c.train.lr = 1e-3
        c.train.warmup_steps = 2
        c.train.steps = 20
    jst = JTS.init_train_state(jcfg, jax.random.PRNGKey(0))
    tst = port_state(tcfg, jst)
    jstep = jax.jit(JTS.make_train_step(jcfg))
    tstep = TTS.make_train_step(tcfg)
    losses, gaps = {"jax": [], "torch": []}, []
    for i in range(STEPS):
        batch = make_batch(tcfg.model, seed=10 + i)
        if forced:
            tst = port_state(tcfg, jst)
        tst, tm = tstep(tst, torch_batch(batch))
        jst, jm = jstep(jst, jax_batch(batch))
        losses["jax"].append(float(jm["loss"]))
        losses["torch"].append(float(tm["loss"]))
        gaps.append(tree_rel(tst.params, np_tree(jst.params)))
        assert int(tst.step) == int(tst.opt.step) == i + 1
    return losses, gaps


def check(arch: str, int8: bool, forced: bool, pin: float,
          params_pin: float):
    losses, gaps = run(arch, int8, forced)
    for i, (a, b) in enumerate(zip(losses["torch"], losses["jax"])):
        assert abs(a - b) <= pin * abs(b), (i, a, b)
    assert max(gaps) <= params_pin, gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_five_steps_match_jax(arch):
    if arch in ROUTED:
        check(arch, int8=False, forced=True, pin=1e-3, params_pin=1e-3)
    else:
        check(arch, int8=False, forced=False, pin=1e-4, params_pin=1e-4)
