"""The port's step checkpoints and artifacts against the JAX package's.

The on-disk format is shared both ways: a JAX ``Checkpointer`` writes a
smoke TrainState (fp32, and one with bf16 parameters) and the port's
``load_arrays``/``restore`` read every leaf bitwise (bf16 through the
int16 view, no numpy bf16); a checkpoint the port writes is read bitwise
by the JAX package's ``load_arrays`` and ``restore``. A flipped byte, a
truncated npz and a newer schema each raise ``CheckpointIntegrityError``;
retention keeps ``keep`` steps; a failed async write surfaces on
``wait``. Artifacts round-trip bitwise (``QuantizedTensor`` and bf16
leaves too) as plain containers; a flipped byte or a newer schema raises
``ArtifactIntegrityError``, a missing sidecar warns, and no ``.tmp`` is
left behind.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import json
import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed.checkpoint import Checkpointer as JCheckpointer
from repro.training.train_step import init_train_state
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.pipeline import pack_for_serving
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed import checkpoint as C
from repro_torch.models import transformer as TT


def _bits(a):
    """A leaf's raw bits as numpy (torch bf16 and ml_dtypes bf16 alike)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(jax.device_get(a))
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _jax_flat(state):
    """{path: leaf} of a JAX tree, named as the JAX Checkpointer names it."""
    from repro.distributed.checkpoint import _tree_paths
    return dict(_tree_paths(state))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_state(request):
    cfg = jget_config("opt-proxy", smoke=True)
    state = init_train_state(cfg, jax.random.PRNGKey(0))
    if request.param == "bfloat16":
        state = state._replace(params=jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16), state.params))
    return request.param, state


def _torch_like(state):
    """The JAX tree's structure (NamedTuples included) with torch leaves."""
    def like(a):
        a = np.asarray(jax.device_get(a))
        dt = (torch.bfloat16 if a.dtype == ml_dtypes.bfloat16
              else torch.from_numpy(np.zeros((), a.dtype)).dtype)
        return torch.zeros(a.shape, dtype=dt)
    return jax.tree_util.tree_map(like, state)


def test_port_reads_a_jax_checkpoint_bitwise(jax_state, tmp_path):
    dtype, state = jax_state
    JCheckpointer(str(tmp_path), async_write=False).save(
        7, state, extra={"step": 7})
    ck = C.Checkpointer(str(tmp_path))
    assert ck.latest_step() == 7
    flat, extra = ck.load_arrays()
    want = _jax_flat(state)
    assert extra == {"step": 7}
    assert sorted(flat) == sorted(want)
    assert ".params/blocks/0/sub0/mixer/q/w" in flat
    bf16 = [n for n, t in flat.items() if t.dtype == torch.bfloat16]
    assert bool(bf16) == (dtype == "bfloat16")
    for name, a in want.items():
        np.testing.assert_array_equal(_bits(flat[name]), _bits(a), name)
    # restore into a torch tree of the JAX structure: NamedTuples rebuilt
    restored, _ = ck.restore(_torch_like(state))
    assert type(restored) is type(state)
    got = dict(C.tree_paths(restored))
    for name, a in want.items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(a), name)


def test_port_reads_the_trainer_params_into_the_port_layout(jax_state,
                                                            tmp_path):
    """The launcher's hand-off: ``.params/…`` leaves → the port's tree."""
    _, state = jax_state
    JCheckpointer(str(tmp_path), async_write=False).save(1, state)
    flat, _ = C.Checkpointer(str(tmp_path)).load_arrays()
    params = params_from_numpy(C.tree_from_paths(
        {k[len(".params/"):]: v for k, v in flat.items()
         if k.startswith(".params/")}))
    want = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(jax.device_get(a)), state.params))
    got_l, want_l = C.tree_paths(params), C.tree_paths(want)
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    for (name, a), (_, b) in zip(got_l, want_l):
        np.testing.assert_array_equal(_bits(a), _bits(b), name)


def test_jax_reads_a_port_checkpoint_bitwise(jax_state, tmp_path):
    _, state = jax_state
    ours = _torch_like(state)
    gen = torch.Generator()
    gen.manual_seed(3)
    ours = jax.tree_util.tree_map(
        lambda t: (torch.randn(t.shape, generator=gen) * 4).to(t.dtype),
        ours)
    ck = C.Checkpointer(str(tmp_path), keep=2)
    ck.save(4, ours, extra={"walk": "x"})
    ck.wait()
    jck = JCheckpointer(str(tmp_path))
    flat, extra = jck.load_arrays()
    assert extra == {"walk": "x"}
    mine = dict(C.tree_paths(ours))
    assert sorted(flat) == sorted(mine)
    for name, a in flat.items():
        np.testing.assert_array_equal(_bits(a), _bits(mine[name]), name)
    restored, _ = jck.restore(state)
    for name, a in _jax_flat(restored).items():
        np.testing.assert_array_equal(_bits(a), _bits(mine[name]), name)


def _small_tree():
    gen = torch.Generator()
    gen.manual_seed(0)
    return {"w": torch.randn((8, 4), generator=gen),
            "h": torch.randn((2, 3), generator=gen).to(torch.bfloat16),
            "n": [torch.arange(5, dtype=torch.int32), torch.tensor(True)]}


def _step_dir(path, step):
    return os.path.join(path, f"step_{step:09d}")


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("damage", ["flipped_byte", "truncated_npz",
                                    "newer_schema"])
def test_a_damaged_checkpoint_raises(damage, tmp_path):
    ck = C.Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, _small_tree())
    d = _step_dir(str(tmp_path), 1)
    npz = os.path.join(d, "arrays.npz")
    if damage == "flipped_byte":
        _flip(npz, os.path.getsize(npz) // 3)
    elif damage == "truncated_npz":
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)
    else:
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        m["schema"] = C.CHECKPOINT_SCHEMA + 1
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(m, f)
    with pytest.raises(C.CheckpointIntegrityError):
        ck.load_arrays()


def test_a_leaf_whose_bytes_changed_raises_on_its_crc(tmp_path):
    """A leaf rewritten inside a valid npz: the zip is sound, the crc32
    in the manifest is not."""
    ck = C.Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, _small_tree())
    npz = os.path.join(_step_dir(str(tmp_path), 1), "arrays.npz")
    with np.load(npz) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["w"] = arrays["w"] + 1
    np.savez(npz, **arrays)
    with pytest.raises(C.CheckpointIntegrityError, match="crc32"):
        ck.load_arrays()


def test_retention_atomicity_and_restore(tmp_path):
    ck = C.Checkpointer(str(tmp_path), keep=2)
    tree = _small_tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree, extra={"s": s})
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004"]
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    os.makedirs(_step_dir(str(tmp_path), 5) + ".tmp")   # a crashed write
    assert ck.latest_step() == 4
    like = {"w": torch.zeros(8, 4), "h": torch.zeros(2, 3,
                                                     dtype=torch.bfloat16),
            "n": [torch.zeros(5, dtype=torch.int32), torch.tensor(False)]}
    got, extra = ck.restore(like)
    assert extra == {"s": 4}
    for (n, a), (_, b) in zip(C.tree_paths(got), C.tree_paths(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    with pytest.raises(ValueError, match="shape"):
        ck.restore(dict(like, w=torch.zeros(4, 8)))


def test_a_failed_async_write_surfaces_on_wait(tmp_path):
    d = tmp_path / "ck"
    ck = C.Checkpointer(str(d))
    d.rmdir()
    d.write_text("a file where the directory was")
    ck.save(1, _small_tree())
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ck.wait()


def _packed_smoke():
    cfg = tget_config("opt-proxy", smoke=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_params(cfg.model, gen, "cpu")
    params["final_norm"]["scale"] = params["final_norm"]["scale"].to(
        torch.bfloat16)
    return pack_for_serving(cfg, params)


def test_artifact_round_trips_bitwise_as_plain_containers(tmp_path):
    packed = _packed_smoke()
    path = str(tmp_path / "a.params.pkl")
    man = C.save_artifact(path, packed, extra={"arch": "opt-proxy-smoke"})
    assert sorted(os.listdir(tmp_path)) == ["a.params.pkl",
                                           "a.params.pkl.manifest.json"]
    assert man["bytes"] == os.path.getsize(path)
    with open(C.artifact_manifest_path(path)) as f:
        side = json.load(f)
    assert side["schema"] == 1 and side["extra"] == {"arch":
                                                     "opt-proxy-smoke"}
    assert set(side) == {"schema", "sha256", "bytes", "time", "extra"}
    back = params_from_numpy(C.load_artifact(path))
    got, want = C.tree_paths(back), C.tree_paths(packed)
    assert sorted(n for n, _ in got) == sorted(n for n, _ in want)
    want_d = dict(want)
    for name, a in got:
        b = want_d[name]
        if isinstance(b, QuantizedTensor):
            assert isinstance(a, QuantizedTensor)
            assert (a.shape, a.bits, a.group_size) == (b.shape, b.bits,
                                                       b.group_size)
            for f in ("packed", "scales", "zeros"):
                assert torch.equal(getattr(a, f), getattr(b, f)), name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name
    # the same tree pickles to the same bytes: the digest is the tree's
    again = C.save_artifact(str(tmp_path / "b.params.pkl"), back)
    assert again["sha256"] == man["sha256"]


def test_artifact_flipped_byte_or_newer_schema_raises(tmp_path):
    path = str(tmp_path / "a.params.pkl")
    C.save_artifact(path, _packed_smoke())
    _flip(path, os.path.getsize(path) // 2)
    with pytest.raises(C.ArtifactIntegrityError, match="sha256"):
        C.load_artifact(path)
    path2 = str(tmp_path / "b.params.pkl")
    C.save_artifact(path2, {"x": torch.ones(3)})
    mpath = C.artifact_manifest_path(path2)
    with open(mpath) as f:
        m = json.load(f)
    m["schema"] = C.ARTIFACT_SCHEMA + 1
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(C.ArtifactIntegrityError, match="schema"):
        C.load_artifact(path2)


def test_artifact_without_sidecar_warns_and_loads(tmp_path):
    path = str(tmp_path / "a.params.pkl")
    C.save_artifact(path, {"x": torch.arange(4)})
    os.remove(C.artifact_manifest_path(path))
    with pytest.warns(RuntimeWarning, match="no integrity manifest"):
        raw = C.load_artifact(path)
    np.testing.assert_array_equal(raw["x"], np.arange(4))


def test_artifact_unloadable_payload_raises(tmp_path):
    path = str(tmp_path / "a.params.pkl")
    C.save_artifact(path, {"x": torch.arange(4)})
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    os.remove(C.artifact_manifest_path(path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(C.ArtifactIntegrityError, match="unloadable"):
            C.load_artifact(path)


def test_artifact_payload_names_no_class_of_the_port():
    """Plain containers only: unpickling it needs numpy alone."""
    blob = pickle.dumps(tree_to_numpy(_packed_smoke()))
    assert b"repro" not in blob and b"torch" not in blob
