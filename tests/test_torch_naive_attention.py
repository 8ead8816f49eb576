"""``model.opt_attention=false``: the naive attention baseline against the
JAX package's, on the CPU, in bf16 compute, where it rounds otherwise
than the default path (the scaled query and the probabilities stay fp32,
the score and value products are fp32 × fp32, and decode on a bf16 cache
materializes the head-repeated cache in fp32).

One attention layer at a time, on the JAX package's initial weights
(``convert.params_from_numpy``) and the same seeded bf16 inputs: a prefill
then three decode steps on a bf16 cache for opt-proxy (MHA), internlm2
(GQA) and h2o-danube (its ring of 8 slots, a prefill of 12 past it), the
whisper decoder's cross-attention, and one MLA layer's ``mla_prefill`` /
``mla_decode`` (deepseek smoke). Each output is held against JAX's naive
path at 2e-3 relative (the projections' bf16 roundings, in other sum
orders, are what is left) and lies nearer it than the port's default path
does; the two paths' outputs differ.

On the int8 cache (``serve.kv_cache=int8``) decode reads the history
through ``ops.int8_kv_attention`` under either value, in both packages: a
decode step of internlm2 and of h2o-danube (its int8 ring) gives bitwise
the same logits and caches under both.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

PIN = 2e-3


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def configs(arch: str, opt: bool):
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    for cfg in (jcfg, tcfg):
        cfg.model.dtype = "bfloat16"
        cfg.model.opt_attention = opt
    return jcfg.model, tcfg.model


def layer_params(init, mj, seed: int):
    jp = init(mj, jax.random.PRNGKey(seed))
    tp = params_from_numpy({"m": jax.tree_util.tree_map(np.asarray, jp)})
    return jp, tp["m"]


def bf16_inputs(seed: int, *shape):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def pos(b, s, start=0):
    return np.tile(np.arange(start, start + s, dtype=np.int32), (b, 1))


def as_np(y):
    return (y.float().numpy() if isinstance(y, torch.Tensor)
            else np.asarray(y.astype(jnp.float32)))


def gqa_run(arch: str, j_opt: bool, t_opt: bool):
    """(port outputs, JAX outputs) of a prefill of 12 positions and three
    decode steps of one self-attention layer on a bf16 cache."""
    mj, _ = configs(arch, j_opt)
    _, mt = configs(arch, t_opt)
    bias = arch == "opt-proxy"
    jp, tp = layer_params(lambda m, k: JA.init_attention(m, k, bias=bias),
                          mj, 3)
    window = mt.window_size     # h2o-danube: its ring; the others: 0
    s0, max_len = 12, 16
    slots = min(window, max_len) if window else max_len
    jc = JA.init_kv_cache(mj, 2, slots, jnp.bfloat16)
    tc = TA.init_kv_cache(mt, 2, slots, "cpu", torch.bfloat16)
    xj, xt = bf16_inputs(1, 2, s0, mt.d_model)
    yj, jc = JA.attention_prefill(mj, jp, xj, jnp.asarray(pos(2, s0)), jc,
                                  window=window)
    yt, tc = TA.attention_prefill(mt, tp, xt, torch.from_numpy(
        pos(2, s0)).long(), tc, window=window)
    outs = [(as_np(yt), as_np(yj))]
    for i in range(3):
        xj, xt = bf16_inputs(10 + i, 2, 1, mt.d_model)
        p = np.full((2,), s0 + i, np.int32)
        yj, jc = JA.attention_decode(mj, jp, xj, jnp.asarray(p), jc,
                                     window=window)
        yt, tc = TA.attention_decode(mt, tp, xt, torch.from_numpy(p).long(),
                                     tc, window=window)
        outs.append((as_np(yt), as_np(yj)))
    return outs


def cross_run(arch: str, j_opt: bool, t_opt: bool):
    """The whisper decoder's cross-attention: 5 queries against 16
    encoder positions."""
    mj, _ = configs(arch, j_opt)
    _, mt = configs(arch, t_opt)
    jp, tp = layer_params(JA.init_cross_attention, mj, 5)
    ej, et = bf16_inputs(2, 2, 16, mt.d_model)
    xj, xt = bf16_inputs(3, 2, 5, mt.d_model)
    yj = JA.cross_attention(mj, jp, xj, JA.cross_attention_kv(mj, jp, ej))
    yt = TA.cross_attention(mt, tp, xt, TA.cross_attention_kv(mt, tp, et))
    return [(as_np(yt), as_np(yj))]


def mla_run(arch: str, j_opt: bool, t_opt: bool):
    """One MLA layer: a prefill of 11 positions on a bf16 latent cache of
    16 slots, then three decode steps over the whole cache."""
    mj, _ = configs(arch, j_opt)
    _, mt = configs(arch, t_opt)
    jp, tp = layer_params(JA.init_mla, mj, 4)
    jc = JA.init_mla_cache(mj, 2, 16, jnp.bfloat16)
    tc = TA.init_mla_cache(mt, 2, 16, "cpu", torch.bfloat16)
    xj, xt = bf16_inputs(1, 2, 11, mt.d_model)
    yj, jc = JA.mla_prefill(mj, jp, xj, jnp.asarray(pos(2, 11)), jc)
    yt, tc = TA.mla_prefill(mt, tp, xt, torch.from_numpy(pos(2, 11)).long(),
                            tc)
    outs = [(as_np(yt), as_np(yj))]
    for i in range(3):
        xj, xt = bf16_inputs(10 + i, 2, 1, mt.d_model)
        p = np.full((2,), 11 + i, np.int32)
        yj, jc = JA.mla_decode(mj, jp, xj, jnp.asarray(p), jc)
        yt, tc = TA.mla_decode(mt, tp, xt, torch.from_numpy(p).long(), tc)
        outs.append((as_np(yt), as_np(yj)))
    return outs


CASES = {"opt-proxy": gqa_run, "internlm2-1.8b": gqa_run,
         "h2o-danube-1.8b": gqa_run, "whisper-large-v3": cross_run,
         "deepseek-v3-671b": mla_run}


@pytest.mark.parametrize("arch", list(CASES))
def test_naive_attention_matches_jax_naive(arch):
    run = CASES[arch]
    naive = run(arch, False, False)              # port naive, JAX naive
    against_opt = run(arch, True, False)         # port naive, JAX default
    default = run(arch, True, True)              # port default, JAX default
    for (got, want), (_, j_opt), (t_opt, _) in zip(naive, against_opt,
                                                   default):
        err = rel(got, want)
        assert err <= PIN, err
        assert err < rel(t_opt, want), (err, rel(t_opt, want))
        assert not np.array_equal(got, t_opt)
        assert not np.array_equal(want, j_opt)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b"])
def test_int8_cache_decode_is_bitwise_under_either_flag(arch):
    _, mt = configs(arch, True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_params(mt, gen, "cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, mt.vocab_size, size=(2, 12))).long()
    _, caches = TT.prefill(mt, params, toks, 16, cache_dtype="int8")
    out = {}
    for opt in (True, False):
        m = copy.deepcopy(mt)
        m.opt_attention = opt
        c = copy.deepcopy(caches)
        logits, c = TT.decode_step(m, params, toks[:, -1],
                                   torch.full((2,), 12), c)
        out[opt] = (logits, c)
    (la, ca), (lb, cb) = out[True], out[False]
    assert torch.equal(la, lb)
    for a, b in zip(TT.cache_leaves(ca), TT.cache_leaves(cb)):
        assert torch.equal(a, b)
