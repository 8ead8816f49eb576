"""Step checkpoints and packed serving artifacts, in the JAX package's
on-disk format.

The twin of the JAX package's ``distributed/checkpoint.py``. Layout (one
directory per step)::

    <ckpt_dir>/step_000123/
        manifest.json      # schema, step, per-leaf dtype/shape/crc32, extra
        arrays.npz         # the leaves, one npz member per path
    <ckpt_dir>/LATEST      # atomic pointer (tmp + rename)

The format is the JAX one both ways: a leaf's name is its path as the JAX
package writes it (dict keys, list indices, ``.field`` for a NamedTuple
field, joined by ``/``: a JAX TrainState's parameters are
``.params/blocks/0/sub0/mixer/q/w`` and so on), bfloat16 leaves are stored
as a ``uint16`` view with ``"bfloat16"`` in the manifest, and the crc32 is
taken over those encoded bytes. A bfloat16 leaf is decoded through an
int16 view straight into ``torch.bfloat16``, so reading needs no numpy
bfloat16 dtype. Loads return CPU tensors.

- **atomic**: a step lands in ``step_*.tmp`` and is renamed only after its
  manifest is fsynced; ``LATEST`` is replaced atomically after that.
- **async**: ``save()`` copies the leaves to the host and hands the file
  I/O to a writer thread; its error surfaces on the next ``wait``/``save``.
- **integrity**: every load checks the manifest's schema, materialises
  every npz member and verifies each crc32; any failure is a
  :class:`CheckpointIntegrityError`, never a silent load.
- **retention**: the newest ``keep`` steps are kept.

Packed serving artifacts (the ``launch.quantize`` → ``launch.serve``
hand-off) get the same guarantee through :func:`save_artifact` /
:func:`load_artifact`: an atomically written pickle of plain containers
(``convert.tree_to_numpy``: numpy arrays, Python scalars, a
``QuantizedTensor`` as the dict of its fields), so unpickling it names no
class of this package, plus a ``<path>.manifest.json`` sidecar holding the
payload's sha256.

Every load passes the ``checkpoint.load`` fault site first: armed with
mode ``corrupt`` it raises the typed integrity error that real damage
gives, with any other mode a ``FaultError``.

**Preemption**: :class:`SignalCheckpointer` flips a flag on SIGTERM; the
trainer reads it at each step boundary and checkpoints before it exits.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import signal
import threading
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import tree_to_numpy
from repro_torch.core import faults
from repro_torch.distributed import sharding

#: manifest schema written by Checkpointer.save; schema 1 (no crc fields)
#: loads unverified, anything newer is refused
CHECKPOINT_SCHEMA = 2
#: sidecar schema written by save_artifact
ARTIFACT_SCHEMA = 1


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint failed verification at load: unreadable npz or
    manifest, a per-leaf crc32 mismatch, or a schema this code does not
    understand. Typed so callers (``quant.resume=auto``) can tell
    corruption from absence or staleness."""


class ArtifactIntegrityError(CheckpointIntegrityError):
    """A packed serving artifact failed its sha256 sidecar check."""


def _fire_load_fault(what: str) -> None:
    """The ``checkpoint.load`` site: mode ``corrupt`` raises the typed
    integrity error, any other mode a ``FaultError``."""
    spec = faults.poll("checkpoint.load")
    if spec is not None:
        if spec.mode == "corrupt":
            raise CheckpointIntegrityError(
                f"{what}: injected corruption (checkpoint.load:corrupt)")
        raise faults.FaultError("checkpoint.load", spec.mode,
                                faults.PLANE.hits["checkpoint.load"])


# npz cannot hold bfloat16: such leaves are stored as a same-width integer
# view and the manifest keeps the logical dtype
_NPZ_VIEW_CODEC: Dict[str, str] = {"bfloat16": "uint16"}


def _encode(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf → (the array that lands in the npz, its logical dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    view = _NPZ_VIEW_CODEC.get(str(a.dtype))
    return (a.view(view) if view else a), str(a.dtype)


def _decode(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    a = np.asarray(a, order="C")
    if dtype_str == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _crc32(a: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (no copy when contiguous)."""
    return zlib.crc32(np.asarray(a, order="C").reshape(-1).view(np.uint8))


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) of a container in the JAX package's flattening
    order and naming; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def tree_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, named as the JAX package names them;
    ``None`` holds no leaf."""
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for part, child in kids:
        out.extend(tree_paths(child, f"{prefix}/{part}" if prefix else part))
    return out


def tree_digest(tree: Any) -> str:
    """The sha256 :func:`save_artifact` would record for ``tree``, without
    writing it (the sharded launcher compares the ranks' packed artifacts
    by it)."""
    return hashlib.sha256(pickle.dumps(
        tree_to_numpy(tree), protocol=pickle.HIGHEST_PROTOCOL)).hexdigest()


def map_with_path(tree: Any, leaf_fn, prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by leaf_fn(path, leaf),
    the path named as :func:`tree_paths` names it."""
    kids = _children(tree)
    if kids is None:
        return None if tree is None else leaf_fn(prefix, tree)
    new = {part: map_with_path(child, leaf_fn,
                          f"{prefix}/{part}" if prefix else part)
           for part, child in kids}
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(new[f".{f}"] for f in tree._fields))
    vals = [new[str(i)] for i in range(len(tree))]
    return vals if isinstance(tree, list) else tuple(vals)


def restore_like(flat: Dict[str, torch.Tensor], tree_like: Any,
                 device: Any = None) -> Any:
    """``tree_like``'s structure filled from ``{path: tensor}``, each leaf
    in its like's dtype, on ``device`` (default: the like's device). A
    missing leaf raises KeyError, another shape ValueError."""
    def leaf(name, like):
        if name not in flat:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        t = flat[name]
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)} (a restore takes the "
                             "configuration's parameter shapes)")
        return t.to(device=device or like.device, dtype=like.dtype)

    return map_with_path(tree_like, leaf)


def tree_from_paths(flat: Dict[str, Any]) -> Any:
    """Nest ``{path: leaf}`` into dicts keyed by path part; a dict whose
    keys are all indices 0..n-1 becomes a list (a JAX list such as
    ``blocks``)."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy the leaves to the host now, then write (async by default)."""
        self.wait()
        arrays: Dict[str, np.ndarray] = {}
        leaves: Dict[str, Dict[str, Any]] = {}
        for name, leaf in tree_paths(tree):
            enc, dtype = _encode(leaf)
            arrays[name] = enc
            leaves[name] = {"shape": list(enc.shape), "dtype": dtype,
                            "crc32": _crc32(enc)}
        manifest = {"schema": CHECKPOINT_SCHEMA, "step": int(step),
                    "time": time.time(),
                    "treedef": f"repro_torch tree of {len(leaves)} leaves",
                    "leaves": leaves, "extra": extra or {}}

        def write():
            try:
                final = os.path.join(self.dir, f"step_{step:09d}")
                tmp = final + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                ltmp = os.path.join(self.dir, "LATEST.tmp")
                with open(ltmp, "w") as f:
                    f.write(os.path.basename(final))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(ltmp, os.path.join(self.dir, "LATEST"))
                self._gc()
            except BaseException as e:   # surfaced on the next save/wait
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def _read_verified(self, step: int
                       ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """Read and verify one step directory: the manifest's schema, every
        npz member materialised, each crc32 (schema ≥ 2). Anything
        unreadable or mismatched raises :class:`CheckpointIntegrityError`."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        _fire_load_fault(d)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointIntegrityError(
                f"{d}: unreadable manifest ({e!r})") from e
        schema = manifest.get("schema", 1)
        if schema > CHECKPOINT_SCHEMA:
            raise CheckpointIntegrityError(
                f"{d}: manifest schema {schema} is newer than supported "
                f"{CHECKPOINT_SCHEMA}")
        encoded: Dict[str, np.ndarray] = {}
        try:
            # an npz loads lazily; reading each member runs the zip CRC, so
            # truncation and flipped bytes in the container surface here
            with np.load(os.path.join(d, "arrays.npz")) as data:
                for name in manifest["leaves"]:
                    encoded[name] = data[name]
        except Exception as e:     # noqa: BLE001 — wrapped as typed error
            raise CheckpointIntegrityError(
                f"{d}: unreadable arrays.npz ({e!r})") from e
        for name, meta in manifest["leaves"].items():
            want = meta.get("crc32")
            if want is None:       # schema-1 checkpoint: nothing to verify
                continue
            got = _crc32(encoded[name])
            if got != want:
                raise CheckpointIntegrityError(
                    f"{d}: leaf {name!r} crc32 mismatch "
                    f"(stored {want}, recomputed {got})")
        return manifest, encoded

    def _step(self, step: Optional[int]) -> int:
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return step

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, Dict[str, Any]]:
        """Load into the structure of ``tree_like`` (a tree of tensors of
        the whole shapes), each leaf in its like's dtype and on its like's
        device. Elastic: ``shardings`` = ``(specs, mesh)`` keeps this
        rank's block of each whole leaf (``sharding.local``), whatever
        mesh wrote the checkpoint: the stored leaves are whole."""
        flat, extra = self.load_arrays(step)
        tree = restore_like(flat, tree_like)
        if shardings is not None:
            tree = sharding.local(tree, *shardings)
        return tree, extra

    def load_arrays(self, step: Optional[int] = None
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Blind restore: flat ``{path: CPU tensor}`` and the extra dict,
        for callers that rebuild the structure from the paths (the
        quantize resume, a JAX trainer's parameters)."""
        manifest, data = self._read_verified(self._step(step))
        out = {name: _decode(data[name], meta["dtype"])
               for name, meta in manifest["leaves"].items()}
        return out, manifest["extra"]


# ---------------------------------------------------------------------------
# Packed serving artifacts (pickle + sha256 sidecar)
# ---------------------------------------------------------------------------

def artifact_manifest_path(path: str) -> str:
    return path + ".manifest.json"


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_artifact(path: str, tree: Any,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Atomically write a torch tree as a pickle of plain containers
    (``convert.tree_to_numpy``) and its integrity sidecar
    (``<path>.manifest.json``: schema, sha256, bytes, time, extra).
    Returns the manifest."""
    payload = pickle.dumps(tree_to_numpy(tree),
                           protocol=pickle.HIGHEST_PROTOCOL)
    manifest = {"schema": ARTIFACT_SCHEMA,
                "sha256": hashlib.sha256(payload).hexdigest(),
                "bytes": len(payload), "time": time.time(),
                "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _write_atomic(path, payload)
    _write_atomic(artifact_manifest_path(path),
                  json.dumps(manifest, indent=1).encode())
    return manifest


def load_artifact(path: str) -> Any:
    """Load an artifact through its integrity sidecar: the plain tree
    (``convert.params_from_numpy`` turns it into tensors).

    The sha256 is verified before unpickling; a digest mismatch, an
    unreadable sidecar, a newer schema or an unloadable payload raises
    :class:`ArtifactIntegrityError`. A missing sidecar (an artifact from
    before the sidecar) loads with a warning."""
    _fire_load_fault(path)
    with open(path, "rb") as f:
        payload = f.read()
    mpath = artifact_manifest_path(path)
    if not os.path.exists(mpath):
        warnings.warn(
            f"{path}: no integrity manifest sidecar — loading unchecked "
            "(legacy artifact; re-save with save_artifact to cover it)",
            RuntimeWarning, stacklevel=2)
    else:
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ArtifactIntegrityError(
                f"{mpath}: unreadable manifest ({e!r})") from e
        schema = manifest.get("schema", 1)
        if schema > ARTIFACT_SCHEMA:
            raise ArtifactIntegrityError(
                f"{path}: artifact schema {schema} is newer than supported "
                f"{ARTIFACT_SCHEMA}")
        digest = hashlib.sha256(payload).hexdigest()
        if manifest.get("sha256") != digest:
            raise ArtifactIntegrityError(
                f"{path}: sha256 mismatch (manifest "
                f"{manifest.get('sha256')!r}, payload {digest!r}) — "
                "artifact is corrupt or was modified after save")
    try:
        return pickle.loads(payload)
    except Exception as e:         # noqa: BLE001 — wrapped as typed error
        raise ArtifactIntegrityError(
            f"{path}: unloadable artifact ({e!r})") from e


class SignalCheckpointer:
    """SIGTERM → a checkpoint requested at the next step boundary
    (``requested``); ``install`` / ``uninstall`` set and restore the
    handler (from the main thread)."""

    def __init__(self):
        self.requested = False
        self._orig: Dict[int, Any] = {}

    def install(self) -> "SignalCheckpointer":
        for sig in (signal.SIGTERM,):
            self._orig[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame) -> None:
        self.requested = True

    def uninstall(self) -> None:
        for sig, h in self._orig.items():
            signal.signal(sig, h)
        self._orig.clear()
