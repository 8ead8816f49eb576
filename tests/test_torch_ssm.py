"""The port's Mamba-1 path (falcon-mamba) against the JAX package.

Same seeded numpy inputs through the JAX function and the port's:

- the plain ``ref.selective_scan`` against the JAX oracle
  ``ref.selective_scan_ref`` in fp32 (y and h_last within 1e-5 of their
  largest value, nonzero h0), against ``selective_scan_pallas`` in
  interpret mode at the JAX package's own pin between its oracle and its
  kernel (rtol = atol = 1e-4, ``tests/test_kernels.py``), and with bf16 u
  (y within one bf16 ulp, taken at no less than 1e-3 of the largest);
- ``causal_conv1d`` with and without an incoming state (fp32, 1e-6 of the
  largest output; the state in x's dtype);
- ``mamba_block`` and ``mamba_decode`` on converted JAX weights (relative
  error fp32 <= 1e-5, bf16 <= 2e-2: on the CPU the JAX block runs its
  chunked associative scan, which sums in another order), the state
  dtypes after prefill and decode and the ``"int8"`` -> bf16 state;
- the config (dt_rank, layer kinds, kinds not yet ported raise) and the
  unstacking of falcon-mamba smoke's one ``("mamba",)`` segment.

The CPU dispatch of ``ops.selective_scan`` is checked with the other
kernels' in ``tests/test_torch_kernels.py``.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as TT

from test_torch_kernels import bf16_ulp, scan_case
from test_torch_models import rel, to_numpy

ARCH = "falcon-mamba-7b"


def t(a):
    return torch.from_numpy(np.array(a))


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# the plain selective scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d,n,h0_scale", [
    (2, 64, 32, 8, 0.1), (1, 77, 64, 16, 1.0), (3, 5, 16, 4, 0.0),
    (2, 33, 128, 16, 0.5)])
def test_scan_matches_jax_oracle(b, s, d, n, h0_scale):
    args = scan_case(np.random.RandomState(b * 31 + s), b, s, d, n,
                     h0_scale=h0_scale)
    y, h = tref.selective_scan(*(t(a) for a in args))
    yj, hj = jref.selective_scan_ref(*(jnp.asarray(a) for a in args))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert max_rel(y.numpy(), yj) <= 1e-5
    assert max_rel(h.numpy(), hj) <= 1e-5


@pytest.mark.parametrize("b,s,d,n,bd,bt", [
    (2, 64, 32, 8, 16, 16), (1, 32, 16, 4, 16, 32),
    (3, 128, 64, 16, 32, 64)])
def test_scan_matches_pallas_interpret(b, s, d, n, bd, bt):
    args = scan_case(np.random.RandomState(b * 7 + s), b, s, d, n)
    y, h = tref.selective_scan(*(t(a) for a in args))
    yp, hp = selective_scan_pallas(*(jnp.asarray(a) for a in args),
                                   block_d=bd, block_t=bt, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hp), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("s", [32, 77])
def test_scan_bf16_u_within_one_ulp(s):
    args = list(scan_case(np.random.RandomState(s), 2, s, 64, 16))
    ut = t(args[0]).to(torch.bfloat16)
    uj = jnp.asarray(args[0]).astype(jnp.bfloat16)
    y, h = tref.selective_scan(ut, *(t(a) for a in args[1:]))
    yj, hj = jref.selective_scan_ref(uj, *(jnp.asarray(a)
                                           for a in args[1:]))
    assert y.dtype == torch.bfloat16
    want = np.asarray(yj.astype(jnp.float32))
    diff = np.abs(y.float().numpy() - want)
    assert np.all(diff <= bf16_ulp(want))
    assert max_rel(h.numpy(), hj) <= 1e-5


# ---------------------------------------------------------------------------
# causal conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.RandomState(4)
    b, s, c, k = 2, 11, 24, 4
    x = rng.randn(b, s, c).astype(np.float32)
    p = {"w": (rng.randn(k, c) * 0.5).astype(np.float32),
         "b": rng.randn(c).astype(np.float32)}
    st = rng.randn(b, k - 1, c).astype(np.float32) if with_state else None
    yt, nt = TL.causal_conv1d({k_: t(v) for k_, v in p.items()}, t(x),
                              None if st is None else t(st))
    yj, nj = JL.causal_conv1d({k_: jnp.asarray(v) for k_, v in p.items()},
                              jnp.asarray(x),
                              None if st is None else jnp.asarray(st))
    assert np.max(np.abs(yt.numpy() - np.asarray(yj))) \
        <= 1e-6 * np.max(np.abs(np.asarray(yj)))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    # bf16 input with an fp32 state: output and new state in x's dtype
    yb, nb = TL.causal_conv1d({k_: t(v) for k_, v in p.items()},
                              t(x).to(torch.bfloat16),
                              None if st is None else t(st))
    assert yb.dtype == nb.dtype == torch.bfloat16
    assert nb.shape == (b, k - 1, c)


# ---------------------------------------------------------------------------
# the Mamba block and its decode step on converted weights
# ---------------------------------------------------------------------------

def _block_setup(dtype):
    jcfg = jget_config(ARCH, smoke=True)
    tcfg = tget_config(ARCH, smoke=True)
    jcfg.model.dtype = tcfg.model.dtype = dtype
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a: a[1],
                                jparams["blocks"][0]["sub0"]["mixer"])
    tp = params_from_numpy(to_numpy(jparams))["layers"][1]["mixer"]
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 12, tcfg.model.d_model) * 0.5).astype(np.float32)
    xt = t(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jcfg, tcfg, jp, tp, xt, xj


TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_and_decode_match_jax(dtype):
    jcfg, tcfg, jp, tp, xt, xj = _block_setup(dtype)
    cdt = getattr(torch, dtype)
    yj, sj = JR.mamba_block(jcfg.model, jp, xj[:, :9], None, name="mixer")
    yt, st = TR.mamba_block(tcfg.model, tp, xt[:, :9], None, name="mixer")
    assert rel(yt.float().numpy(), np.asarray(yj.astype(jnp.float32))) \
        <= TOL[dtype]
    # after prefill both states are in the compute dtype
    assert st["h"].dtype == st["conv"].dtype == cdt
    for k in ("h", "conv"):
        assert rel(st[k].float().numpy(),
                   np.asarray(sj[k].astype(jnp.float32))) <= TOL[dtype]
    for i in range(9, 12):
        yj, sj = JR.mamba_decode(jcfg.model, jp, xj[:, i:i + 1], sj,
                                 name="mixer")
        yt, st = TR.mamba_decode(tcfg.model, tp, xt[:, i:i + 1], st,
                                 name="mixer")
        assert st["h"].dtype == st["conv"].dtype == cdt
        assert rel(yt.float().numpy(),
                   np.asarray(yj.astype(jnp.float32))) <= TOL[dtype]
        assert rel(st["h"].float().numpy(),
                   np.asarray(sj["h"].astype(jnp.float32))) <= TOL[dtype]


def test_prefill_then_decode_equals_the_full_block():
    """The block's h_last and conv state feed the decode recurrence: the
    block over S-1 tokens plus one decode step gives the block's last
    output and state over S tokens (fp32, 1e-5 relative)."""
    _, tcfg, _, tp, xt, _ = _block_setup("float32")
    y_full, s_full = TR.mamba_block(tcfg.model, tp, xt, None, name="m")
    _, st = TR.mamba_block(tcfg.model, tp, xt[:, :-1], None, name="m")
    y_last, s_last = TR.mamba_decode(tcfg.model, tp, xt[:, -1:], st,
                                     name="m")
    assert rel(y_last.numpy(), y_full[:, -1:].numpy()) <= 1e-5
    # the conv state holds in-projection outputs, whose sums the CPU's
    # matmul orders differently for 1 row and for S rows
    for k in ("h", "conv"):
        assert rel(s_last[k].numpy(), s_full[k].numpy()) <= 1e-5


def test_int8_sentinel_maps_the_state_to_bf16():
    tcfg = tget_config(ARCH, smoke=True)
    mc = tcfg.model
    spec = TT.layer_specs(mc)[0]
    assert spec == ("mamba", "none")
    st = TT.init_layer_cache(mc, spec, 2, 16, "cpu", "int8")
    d_inner = mc.ssm.expand * mc.d_model
    assert st["h"].dtype == st["conv"].dtype == torch.bfloat16
    assert st["h"].shape == (2, d_inner, mc.ssm.d_state)
    assert st["conv"].shape == (2, mc.ssm.d_conv - 1, d_inner)
    jst = JT.init_layer_cache(jget_config(ARCH, smoke=True).model,
                              ("mamba", "none"), 2, 16, "int8")
    assert {k: v.shape for k, v in jst.items()} == {
        k: tuple(v.shape) for k, v in st.items()}


# ---------------------------------------------------------------------------
# config and conversion
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    for smoke in (False, True):
        j = jget_config(ARCH, smoke=smoke)
        tc = tget_config(ARCH, smoke=smoke)
        for f in ("num_layers", "d_model", "vocab_size", "norm",
                  "block_pattern", "layer_kinds"):
            assert getattr(tc.model, f) == getattr(j.model, f), f
        # the port reads "mamba" in layer_kinds where JAX reads ssm.enabled
        assert ("mamba" in tc.model.layer_kinds) == j.model.ssm.enabled
        for f in ("d_state", "d_conv", "expand", "dt_rank"):
            assert getattr(tc.model.ssm, f) == getattr(j.model.ssm, f), f
        assert (tc.quant.group_size, tc.quant.blocksize) == \
            (j.quant.group_size, j.quant.blocksize)
    assert tget_config(ARCH).model.ssm.dt_rank == 256


def test_unported_layer_kind_names_the_roadmap():
    """Every layer kind of the JAX package is taken ("rglru" now too, and
    MLA through ``mla.enabled``, not a kind); an unknown kind raises."""
    assert ModelConfig(block_pattern=("rglru",)).layer_kinds == ("rglru",) * 2
    for bad in (("attn", "mla"), ("conv",)):
        with pytest.raises(ValueError, match="unknown block kinds"):
            ModelConfig(block_pattern=bad)


def test_convert_unstacks_the_mamba_segment():
    jcfg = jget_config(ARCH, smoke=True)
    jparams = JT.init_params(jcfg.model, jax.random.PRNGKey(0))
    assert len(jparams["blocks"]) == 1
    seg = jparams["blocks"][0]
    assert list(seg) == ["sub0"]
    tparams = params_from_numpy(to_numpy(jparams))
    assert len(tparams["layers"]) == jcfg.model.num_layers
    for i, layer in enumerate(tparams["layers"]):
        assert set(layer) == {"norm1", "mixer"}
        assert set(layer["mixer"]) == {"in", "conv", "x", "dt", "a_log",
                                       "d_skip", "out"}
        mj = seg["sub0"]["mixer"]
        for path in (("conv", "w"), ("conv", "b"), ("dt", "b"), ("a_log",),
                     ("d_skip",), ("x", "w")):
            a, b = layer["mixer"], mj
            for k in path:
                a, b = a[k], b[k]
            np.testing.assert_array_equal(a.numpy(), np.asarray(b[i]))
