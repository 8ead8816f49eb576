"""The port's models against the JAX models on converted params.

opt-proxy smoke, internlm2 smoke (GQA: 4 heads over 2 KV heads) and
falcon-mamba smoke (Mamba-1: the selective scan at prefill, the recurrent
state at decode) with the JAX package's initial weights carried across by
``convert.params_from_numpy``: full-sequence logits, prefill + 3 decode
steps (bf16 cache), and the packed (int4 ``QuantizedTensor``) forward.
Pins (relative Frobenius error): model dtype float32 ≤ 1e-5; the default
bf16 ≤ 2e-2 (the frameworks round bf16 intermediates at different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.pipeline import pack_for_serving as jpack
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import pack_for_serving as tpack
from repro_torch.core.quant import quantized_leaves
from repro_torch.models import transformer as TT

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (arch, dtype) cases; the opt-proxy cases keep their ids
CASES = [("opt-proxy", "float32"), ("opt-proxy", "bfloat16"),
         ("internlm2-1.8b", "float32"), ("internlm2-1.8b", "bfloat16"),
         ("falcon-mamba-7b", "float32"), ("falcon-mamba-7b", "bfloat16")]
CASE_IDS = ["float32", "bfloat16", "internlm2-float32", "internlm2-bfloat16",
            "falcon-mamba-float32", "falcon-mamba-bfloat16"]


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jax.device_get(a)),
                                  tree)


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _setup(dtype, arch="opt-proxy"):
    jcfg = jget_config(arch, smoke=True)
    tcfg = tget_config(arch, smoke=True)
    jcfg.model.dtype = tcfg.model.dtype = dtype
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    tparams = params_from_numpy(to_numpy(jparams))
    toks = np.random.RandomState(0).randint(0, tcfg.model.vocab_size,
                                            size=(2, 12))
    return jcfg, tcfg, jparams, tparams, toks


def test_convert_unstacks_layers():
    jcfg, tcfg, jparams, tparams, _ = _setup("float32")
    assert len(tparams["layers"]) == jcfg.model.num_layers
    q = jparams["blocks"][0]["sub0"]["mixer"]["q"]["w"]
    for i, layer in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(layer["mixer"]["q"]["w"].numpy(),
                                      np.asarray(q[i]))


@pytest.mark.parametrize("arch,dtype", CASES, ids=CASE_IDS)
def test_forward_logits(arch, dtype):
    jcfg, tcfg, jparams, tparams, toks = _setup(dtype, arch)
    lj, _ = JT.forward(jcfg.model, jparams, jnp.asarray(toks))
    lt = TT.forward(tcfg.model, tparams, torch.from_numpy(toks))
    assert lt.dtype == torch.float32
    assert lt.shape == (2, 12, tcfg.model.vocab_size)
    assert rel(lt.numpy(), lj) <= TOL[dtype]


@pytest.mark.parametrize("arch,dtype", CASES, ids=CASE_IDS)
def test_prefill_and_decode_logits(arch, dtype):
    jcfg, tcfg, jparams, tparams, toks = _setup(dtype, arch)
    max_len = 16
    lj, cj = JT.prefill(jcfg.model, jparams, jnp.asarray(toks), max_len)
    lt, ct = TT.prefill(tcfg.model, tparams, torch.from_numpy(toks), max_len)
    assert rel(lt.numpy(), lj) <= TOL[dtype]
    nxt = np.random.RandomState(1).randint(0, tcfg.model.vocab_size,
                                           size=(3, 2))
    for i in range(3):
        pos = np.full((2,), 12 + i, np.int32)
        lj, cj = JT.decode_step(jcfg.model, jparams, jnp.asarray(nxt[i]),
                                jnp.asarray(pos), cj)
        lt, ct = TT.decode_step(tcfg.model, tparams,
                                torch.from_numpy(nxt[i]).long(),
                                torch.from_numpy(pos).long(), ct)
        assert rel(lt.numpy(), lj) <= TOL[dtype]


@pytest.mark.parametrize("arch,dtype", CASES, ids=CASE_IDS)
def test_packed_forward(arch, dtype):
    jcfg, tcfg, jparams, tparams, toks = _setup(dtype, arch)
    jpacked = jpack(jcfg, jparams)
    tpacked = params_from_numpy(to_numpy(jpacked))
    mine = tpack(tcfg, tparams)
    theirs, ours = (dict(quantized_leaves(p["layers"]))
                    for p in (tpacked, mine))
    assert list(ours) == list(theirs) and ours
    for k, qt in ours.items():
        torch.testing.assert_close(qt.packed, theirs[k].packed, rtol=0,
                                   atol=0)
    lj, _ = JT.forward(jcfg.model, jpacked, jnp.asarray(toks))
    lt = TT.forward(tcfg.model, tpacked, torch.from_numpy(toks))
    assert rel(lt.numpy(), lj) <= TOL[dtype]


def test_rmsnorm_and_gated_mlp_match_jax():
    from repro.config import ModelConfig as JModelConfig
    from repro.models import layers as JL
    from repro_torch.config import ModelConfig as TModelConfig
    from repro_torch.models import layers as TL
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 32).astype(np.float32)
    p = {"scale": (rng.randn(32) * 0.1).astype(np.float32)}
    np.testing.assert_allclose(
        TL.rmsnorm({"scale": torch.from_numpy(p["scale"])},
                   torch.from_numpy(x)).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(p["scale"])},
                              jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    mp = {k: {"w": (rng.randn(*shape) * 0.2).astype(np.float32)}
          for k, shape in (("gate", (32, 48)), ("up", (32, 48)),
                           ("down", (48, 32)))}
    kw = dict(d_model=32, d_ff=48, act="silu", gated_mlp=True,
              dtype="float32")
    yj = JL.mlp(JModelConfig(**kw), jax.tree_util.tree_map(jnp.asarray, mp),
                jnp.asarray(x))
    yt = TL.mlp(TModelConfig(**kw), {k: {"w": torch.from_numpy(v["w"])}
                                     for k, v in mp.items()},
                torch.from_numpy(x))
    assert rel(yt.numpy(), yj) <= 1e-5


def test_config_overrides():
    from repro_torch.config import apply_overrides, parse_overrides
    cfg = tget_config("opt-proxy", smoke=True)
    apply_overrides(cfg, parse_overrides(
        ["model.dtype=float32", "quant.rpiq_iters=3",
         "quant.rpiq_early_stop=false", "quant.rpiq_alpha=0.5"]))
    assert (cfg.model.dtype, cfg.quant.rpiq_iters, cfg.quant.rpiq_early_stop,
            cfg.quant.rpiq_alpha) == ("float32", 3, False, 0.5)
    with pytest.raises(KeyError):
        apply_overrides(cfg, {"quant.nope": "1"})
    with pytest.raises(ValueError):
        parse_overrides(["no-equals"])
