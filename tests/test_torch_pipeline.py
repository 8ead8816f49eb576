"""The port's quantize → pack → serve path against the JAX package.

opt-proxy smoke at model dtype float32, the same converted initial weights
and the same calibration stream (``MarkovLM(256, seed=7)``, 3 batches of
4 × 32), against JAX with ``quant.jit_capture=false`` (the eager capture
the port mirrors). Pins: per-linear record names, modes and ``iters_run``
equal; Γ histories ≤ 1e-3 relative; packed codes differ in ≤ 1e-2 of the
bytes; logits of the packed models ≤ 1e-3 relative. Then greedy
``generate`` on the converted JAX-packed params gives the JAX engine's
tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.pipeline import pack_for_serving as jpack
from repro.core.pipeline import quantize_model as jquantize
from repro.data import MarkovLM as JMarkovLM
from repro.data import calibration_batches as jcalib
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import pack_for_serving as tpack
from repro_torch.core.pipeline import quantize_model as tquantize
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import calibration_batches as tcalib
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine

from test_torch_models import rel, to_numpy


@pytest.fixture(scope="module")
def runs():
    jcfg = jget_config("opt-proxy", smoke=True)
    jcfg.model.dtype = "float32"
    jcfg.quant.jit_capture = False
    tcfg = tget_config("opt-proxy", smoke=True)
    tcfg.model.dtype = "float32"
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    tparams = params_from_numpy(to_numpy(jparams))
    jc = jcalib(JMarkovLM(256, seed=7), 3, 4, 32)
    tc = tcalib(TMarkovLM(256, seed=7), 3, 4, 32)
    jq, jrep = jquantize(jcfg, jparams, jc)
    tq, trep = tquantize(tcfg, tparams, tc, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jc=jc, tc=tc, jq=jq, jrep=jrep,
                tq=tq, trep=trep)


def test_calibration_streams_identical(runs):
    for a, b in zip(runs["jc"], runs["tc"]):
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(a["tokens"]))


def test_report_records_match(runs):
    jl, tl = runs["jrep"].linears, runs["trep"].linears
    assert [r.name for r in tl] == [r.name for r in jl]
    assert len(tl) == runs["tcfg"].model.num_layers * 6
    for a, b in zip(tl, jl):
        assert (a.mode, a.iters, a.shape) == (b.mode, b.iters,
                                              tuple(b.shape)), a.name
        np.testing.assert_allclose(a.gamma, b.gamma, rtol=1e-3)


def test_packed_codes_and_logits_match(runs):
    jpacked = params_from_numpy(to_numpy(jpack(runs["jcfg"], runs["jq"])))
    tpacked = tpack(runs["tcfg"], runs["tq"])
    diff = total = 0
    for a, b in zip(tpacked["layers"], jpacked["layers"]):
        for sub, names in (("mixer", "qkvo"), ("mlp", ("up", "down"))):
            for k in names:
                pa, pb = a[sub][k]["w"].packed, b[sub][k]["w"].packed
                diff += int((pa != pb).sum())
                total += pa.numel()
    assert diff / total <= 1e-2
    toks = runs["tc"][-1]["tokens"]
    lt = TT.forward(runs["tcfg"].model, tpacked, toks)
    lj, _ = JT.forward(runs["jcfg"].model, jpack(runs["jcfg"], runs["jq"]),
                       jnp.asarray(toks.numpy()))
    assert rel(lt.numpy(), lj) <= 1e-3


def test_generate_greedy_tokens_equal(runs):
    jpacked = jpack(runs["jcfg"], runs["jq"])
    tpacked = params_from_numpy(to_numpy(jpacked))
    prompt = JMarkovLM(256, seed=3).batch(2, 8)
    jr = jengine.generate(runs["jcfg"], jpacked, prompt, max_new_tokens=6)
    tr = tengine.generate(runs["tcfg"], tpacked,
                          {"tokens": torch.from_numpy(
                              np.array(prompt["tokens"])).long()},
                          device="cpu", max_new_tokens=6)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))
    np.testing.assert_allclose(tr.logprobs.numpy(), np.asarray(jr.logprobs),
                               rtol=1e-4, atol=1e-5)
