"""The port's training pieces against the JAX package's, on the CPU.

Every case feeds both packages the same numpy inputs made from a seed;
the parameters cross over leaf for leaf (``convert.tree_from_numpy``:
a JAX TrainState's stacked layout is the port's training layout). Where
the reference computes in fp32 both run in fp32 (``model.dtype=float32``).
Pins:

- schedules (constant, cosine, WSD): ≤ 1e-7 relative at every step, past
  the end too (a value that decays to zero is held at 1e-7 of the base
  rate);
- ``adamw_update`` from identical params, grads and state: fp32 moments
  and parameters ≤ 1e-6 relative over three steps; int8 moments: codes
  equal but at rounding ties (≤ 1e-3 of the codes, off by 1), scales
  ≤ 1e-6, parameters ≤ 1e-6; ``clip_by_global_norm`` ≤ 1e-6;
- ``loss_fn`` and its gradients on JAX-converted params, per leaf ≤ 1e-5
  relative for opt-proxy, whisper (frames), pixtral (embeds and a loss
  mask), falcon-mamba (the plain scan) and recurrentgemma; a leaf whose
  exact gradient is zero (a key bias: the softmax ignores a shift common
  to every key) is held at 1e-5 of a thousandth of the whole gradient's
  norm. olmoe (the load-balance loss) and deepseek (MTP): both packages
  run the routed experts in bf16 whatever ``model.dtype`` says, so they
  are held against the JAX loss composed op by op (``JT.forward`` with
  ``unroll_eager``, the precedent of tests/test_torch_moe.py): the loss
  ≤ 1e-5, the gradients ≤ 1e-2 per leaf (the two backwards round the bf16
  expert products in other places, 2e-3 to 3.4e-3 seen), and JAX's own
  scanned ``loss_fn`` value ≤ 1e-3 (its compiled expert products round
  otherwise, 8e-5 seen) (tests/test_torch_train_routed.py);
- remat on against off: loss and gradients bitwise;
- ``grad_accum=2`` against one batch: gradients ≤ 1e-6 per leaf;
- ``SentimentTask`` batches and labels equal, ``accuracy`` equal.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import SentimentTask as JSentiment
from repro.models import transformer as JT
from repro.training import optimizer as jopt
from repro.training import train_step as JTS
from repro.training.schedule import learning_rate as jlr
from repro_torch.config import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import tree_from_numpy
from repro_torch.data import DataState as TDataState
from repro_torch.data import MarkovLM as TMarkovLM
from repro_torch.data import SentimentTask as TSentiment
from repro_torch.distributed.checkpoint import tree_paths
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as TTS
from repro_torch.training.schedule import learning_rate as tlr

ARCHS = ("opt-proxy", "olmoe-1b-7b", "deepseek-v3-671b", "whisper-large-v3",
         "pixtral-12b", "falcon-mamba-7b", "recurrentgemma-9b")
ROUTED = ("olmoe-1b-7b", "deepseek-v3-671b")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree):
    """{path: float64 numpy} of a JAX (numpy) or torch tree, named as the
    checkpoints name them."""
    out = {}
    for k, v in tree_paths(tree):
        if isinstance(v, torch.Tensor):
            v = v.detach().float().numpy()
        out[k] = np.asarray(v, dtype=np.float64)
    return out


def rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
def test_schedules_match_jax(schedule):
    kw = dict(lr=1e-3, warmup_steps=10, steps=100, schedule=schedule,
              wsd_stable_frac=0.6)
    jtc, ttc = JTrainConfig(**kw), TTrainConfig(**kw)
    for s in range(0, 106):
        want = float(jlr(jtc, jnp.asarray(s, jnp.int32)))
        got = float(tlr(ttc, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * max(abs(want), kw["lr"]), \
            (s, got, want)
    assert float(tlr(ttc, 0)) > 0.0


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _opt_case(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(64, 33).astype(np.float32),
              "b": rng.randn(7).astype(np.float32),
              "c": {"w": rng.randn(3, 130).astype(np.float32)}}
    grads = [{k: (jax.tree_util.tree_map(
        lambda x: (rng.randn(*x.shape) * 0.1).astype(np.float32), v))
        for k, v in params.items()} for _ in range(3)]
    return params, grads


def _t(tree):
    return tree_from_numpy(tree)


def _t_moments(tree):
    """A JAX moment tree (f32 arrays or ``Quantized8``) as the port's."""
    def leaf(z):
        if isinstance(z, jopt.Quantized8):
            return topt.Quantized8(torch.from_numpy(np.array(z.q)),
                                   torch.from_numpy(np.array(z.scale)))
        return torch.from_numpy(np.array(z))
    return jax.tree_util.tree_map(
        leaf, tree, is_leaf=lambda x: isinstance(x, jopt.Quantized8))


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_update_matches_jax(int8):
    """Three steps, each from the same inputs on both sides (the JAX
    state converted): fp32 moments ≤ 1e-6; int8 codes equal but at ties
    (≤ 1e-3 of them, off by 1), scales ≤ 1e-6; params ≤ 1e-6."""
    params, grads = _opt_case()
    tc = dict(weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8)
    jtc, ttc = JTrainConfig(**tc), TTrainConfig(**tc)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jopt.adamw_init(jp, int8=int8)
    n_codes = n_off = 0
    for i, g in enumerate(grads):
        tp = _t(np_tree(jp))
        tst = topt.AdamWState(torch.tensor(int(jst.step), dtype=torch.int32),
                              _t_moments(jst.m), _t_moments(jst.v))
        lr = 1e-2 * (i + 1)
        jp, jst = jopt.adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                    jst, jp, lr=jnp.float32(lr), tc=jtc,
                                    int8=int8)
        tp, tst = topt.adamw_update(_t(g), tst, tp,
                                    lr=torch.tensor(lr, dtype=torch.float32),
                                    tc=ttc, int8=int8)
        assert int(tst.step) == int(jst.step) == i + 1
        for k, want in flat(np_tree(jp)).items():
            assert rel(flat(tp)[k], want) <= 1e-6, (i, k)
        for moment in ("m", "v"):
            want = flat(np_tree(getattr(jst, moment)))
            got = flat(getattr(tst, moment))
            assert want.keys() == got.keys()
            for k in want:
                if k.endswith("/.q"):
                    diff = np.abs(got[k] - want[k])
                    assert diff.max() <= 1, (i, moment, k)
                    n_codes += diff.size
                    n_off += int((diff > 0).sum())
                else:
                    assert rel(got[k], want[k]) <= 1e-6, (i, moment, k)
    if int8:
        assert n_off <= 1e-3 * n_codes, (n_off, n_codes)


def test_int8_moments_blocks_and_bytes():
    """``_q8`` / ``_dq8`` against JAX's on one tensor: blocks of 128 over
    the flat tensor zero-padded, ``absmax/127 + 1e-12`` scales, codes
    clipped to ±127 (equal here: no value lies near a tie); the state ~4×
    smaller than fp32 moments."""
    rng = np.random.RandomState(3)
    x = (rng.randn(5, 77) * 3).astype(np.float32)
    jz = jopt._q8(jnp.asarray(x))
    tz = topt._q8(torch.from_numpy(x))
    assert tz.q.dtype == torch.int8 and tuple(tz.q.shape) == (4, 128)
    np.testing.assert_array_equal(tz.q.numpy(), np.asarray(jz.q))
    assert rel(tz.scale.numpy(), np.asarray(jz.scale)) <= 1e-6
    back = topt._dq8(tz, (5, 77)).numpy()
    assert rel(back, np.asarray(jopt._dq8(jz, (5, 77)))) <= 1e-6
    params = {"a": torch.ones(256, 256)}
    f32 = topt.state_bytes(topt.adamw_init(params, int8=False))
    q8 = topt.state_bytes(topt.adamw_init(params, int8=True))
    assert f32 == 2 * 256 * 256 * 4 and q8 < f32 / 3.5


def test_clip_by_global_norm_matches_jax():
    params, grads = _opt_case(5)
    g = {k: jax.tree_util.tree_map(lambda x: x * 30.0, v)
         for k, v in grads[0].items()}
    for max_norm in (1.0, 1e6):
        jc, jn = jopt.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        tc, tn = topt.clip_by_global_norm(_t(g), max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for k, want in flat(np_tree(jc)).items():
            assert rel(flat(tc)[k], want) <= 1e-6, (max_norm, k)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def make_batch(mc, seed: int, b: int = 2, s: int = 16):
    """Numpy inputs for one model: tokens from ``MarkovLM``, frames for an
    encoder-decoder, patch embeddings and a loss mask for a frontend."""
    rng = np.random.RandomState(seed)
    out = {"tokens": TMarkovLM(mc.vocab_size, seed=seed).batch(
        b, s)["tokens"].numpy().astype(np.int32)}
    if mc.is_encoder_decoder:
        out["frames"] = rng.randn(b, mc.encoder_seq_len,
                                  mc.d_model).astype(np.float32)
    if mc.frontend_tokens:
        out["embeds"] = rng.randn(b, mc.frontend_tokens,
                                  mc.d_model).astype(np.float32)
        out["loss_mask"] = (rng.rand(b, s) > 0.3).astype(np.float32)
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in batch.items()}


def configs(arch: str, dtype: str = "float32"):
    jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    jcfg.model.dtype = tcfg.model.dtype = dtype
    return jcfg, tcfg


def jax_params(jcfg, seed: int = 0):
    return JTS.init_train_state(jcfg, jax.random.PRNGKey(seed)).params


def jax_loss_op_by_op(jcfg, params, batch):
    """JAX's ``loss_fn`` of a decoder-only model without embeds, its layers
    run one call at a time (``unroll_eager``)."""
    mc, tokens = jcfg.model, batch["tokens"]
    logits, aux, h = JT.forward(mc, params, tokens, None, unroll_eager=True,
                                return_hidden=True)
    loss = JTS.cross_entropy(logits[:, :-1], tokens[:, 1:], None) + aux
    if mc.mtp_depth > 0:
        mtp = JT.mtp_logits(mc, params, h, tokens)
        loss = loss + mc.mtp_loss_weight * JTS.cross_entropy(
            mtp[:, :-1], tokens[:, 2:], None)
    return loss


def assert_grads_close(got, want, pin):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    floor = 1e-3 * np.sqrt(sum(float(np.sum(w * w)) for w in want.values()))
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= pin * max(np.linalg.norm(want[k]), floor), \
            (k, err, np.linalg.norm(want[k]))


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in ROUTED])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def check_loss_and_grads(arch: str) -> None:
    """The routed models' case runs in tests/test_torch_train_routed.py."""
    jcfg, tcfg = configs(arch)
    jp = jax_params(jcfg)
    batch = make_batch(tcfg.model, seed=1)
    jb = jax_batch(batch)
    tg, tm = TTS.loss_and_grads(tcfg, tree_from_numpy(np_tree(jp)),
                                torch_batch(batch))
    if arch in ROUTED:
        # the routed experts run in bf16 in both packages (module docstring)
        jloss, jm = jax.jit(lambda p: JTS.loss_fn(jcfg, p, jb))(jp)
        assert set(tm) == set(jm)
        assert abs(float(tm["loss"]) - float(jloss)) <= 1e-3 * float(jloss)
        lo, go = jax.value_and_grad(
            lambda p: jax_loss_op_by_op(jcfg, p, jb))(jp)
        assert abs(float(tm["loss"]) - float(lo)) <= 1e-5 * float(lo)
        assert float(tm["aux"]) > 0.0
        assert_grads_close(tg, np_tree(go), 1e-2)
        return
    (_, jm), jg = jax.value_and_grad(
        lambda p: JTS.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])) \
            + 1e-7, k
    assert_grads_close(tg, np_tree(jg), 1e-5)


@pytest.mark.parametrize("arch", ["opt-proxy", "recurrentgemma-9b"])
def test_remat_is_bitwise_no_remat(arch):
    """recurrentgemma's first segment is a 3-layer super-block, recomputed
    as one unit."""
    _, tcfg = configs(arch)
    jcfg, _ = configs(arch)
    params = tree_from_numpy(np_tree(jax_params(jcfg)))
    batch = torch_batch(make_batch(tcfg.model, seed=2))
    out = {}
    for remat in ("none", "full"):
        tcfg.parallel.remat = remat
        out[remat] = TTS.loss_and_grads(tcfg, params, batch)
    assert torch.equal(out["none"][1]["loss"], out["full"][1]["loss"])
    for (k, a), (_, b) in zip(tree_paths(out["none"][0]),
                              tree_paths(out["full"][0])):
        assert torch.equal(a, b), k


def test_grad_accum_matches_one_batch():
    jcfg, tcfg = configs("opt-proxy")
    params = tree_from_numpy(np_tree(jax_params(jcfg)))
    batch = torch_batch(make_batch(tcfg.model, seed=3, b=4))
    one, _ = TTS.accumulated_grads(tcfg, params, batch)
    tcfg.train.grad_accum = 2
    two, m2 = TTS.accumulated_grads(tcfg, params, batch)
    _, last = TTS.loss_and_grads(tcfg, params,
                                 {k: v[2:] for k, v in batch.items()})
    assert torch.equal(m2["loss"], last["loss"])
    assert_grads_close(two, one, 1e-6)


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------

def test_sentiment_task_matches_jax():
    jt, tt = JSentiment(128, seed=4), TSentiment(128, seed=4)
    for _ in range(3):
        (jb, jl), (tb, tl) = jt.batch(5, 24), tt.batch(5, 24)
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        np.testing.assert_array_equal(tb["loss_mask"].numpy(),
                                      np.asarray(jb["loss_mask"]))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tt.state().step == jt.state().step == 3
    logits = np.random.RandomState(0).randn(5, 128).astype(np.float32)
    assert tt.accuracy(torch.from_numpy(logits), tl) == \
        jt.accuracy(jnp.asarray(logits), jl)
    # the stream is a function of (seed, step): a restore resumes it
    tt.restore(TDataState(4, 1))
    fresh = TSentiment(128, seed=4)
    fresh.batch(5, 24)
    np.testing.assert_array_equal(tt.batch(5, 24)[0]["tokens"].numpy(),
                                  fresh.batch(5, 24)[0]["tokens"].numpy())
    with pytest.raises(ValueError, match="seed"):
        tt.restore(TDataState(5, 1))
