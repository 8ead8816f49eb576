"""The rank side of tests/test_torch_sharded_train.py: one gloo world, one
process a rank, every check in one start-up.

    python tests/_torch_sharded_train_checks.py <rank> <world> <dir>

``<dir>/inputs.npz`` holds the inputs the pytest process made (with JAX
and numpy: this file imports no JAX); the ranks meet through
``file://<dir>/rendezvous``. Every rank runs

- ``compress_psum`` over the world, ``"none"`` / ``"bf16"`` / ``"int8"``,
  six steps of error feedback on its block of the gradients;
- ``gpipe_forward``, two stages on (pod 2, data 2, model 1);
- the sharded train step (``CASES``: internlm2-1.8b smoke on 2x2,
  opt-proxy smoke on 4x1, 1x4, 2x2 without fsdp, 2x2 with int8 moments,
  2x2 with ``grad_accum=2`` and a loss mask, 2x2 with ``parallel.sp``
  under fp32 and int8 moments, minicpm-2b smoke on 1x4 (6 heads: the
  attention whole, its MLP and tied vocab split), whisper-large-v3 smoke
  on 2x2 with and without ``parallel.sp``, pixtral-12b smoke with
  ``parallel.sp`` and frontend embeddings on 2x2 and on 1x4 (a sequence
  that does not divide the axis), olmoe-1b-7b smoke on 2x2 with
  local and with global dispatch and on 4x1 with global dispatch; then
  the split of GQA, Mamba and routed experts: internlm2-1.8b smoke on 1x4
  (4 q-heads over 2 kv-heads, each kv-head read by two ranks),
  recurrentgemma-9b smoke on 1x4 (local MQA 4 / 1, RG-LRU by its
  channels, 16 of 64 a rank) and on 2x2 under ``parallel.sp``,
  falcon-mamba-7b smoke on 1x4, on 2x2 and on 2x2 under
  ``parallel.sp``, olmoe-1b-7b smoke on 1x4 (2 experts a rank) and on
  2x2 under ``parallel.sp`` with local dispatch, deepseek-v3-671b smoke
  cut to its one dense layer on 1x4 (1 MLA head a rank, a dense MTP
  layer, the MTP projection at 16 of 64 columns) and at its full smoke
  depth on 2x2 under ``parallel.sp`` with local dispatch (2 heads and 4
  experts a rank, a routed MTP layer); the smoke configs run
  ``parallel.remat=full``); the falcon-mamba, recurrentgemma and
  deepseek 1x4 runs' gathered states are checkpointed (rank 0 writes)
  and restored onto 2x2;
- ``train(mesh=)``: opt-proxy smoke on 2x2 stopped by a SIGTERM that rank
  1 alone receives, then resumed on 4x1 from a copy of its checkpoint;
  the 4x1 run's checkpoint restored onto 2x2 (``Checkpointer.restore(
  shardings=…)``).

Each rank writes ``<dir>/rank<r>.npz`` (every output, whole) and
``<dir>/rank<r>.json`` (metrics, the input widths of the row-parallel
products and the MTP projection's output width in a case's first step,
stop steps, checkpoint writes).

    python -m torch.distributed.run … tests/_torch_sharded_train_checks.py \\
        launcher <log> <launch.train argv>

is one rank of ``launch.train`` that logs each ``Checkpointer.save`` it
makes to ``<log>.<rank>``.
"""
import contextlib
import json
import os
import shutil
import signal
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np                            # noqa: E402
import torch                                  # noqa: E402
import torch.distributed as dist              # noqa: E402

# name → (arch, mesh (data, model), steps, overrides of the config)
CASES = {
    "intern": ("internlm2-1.8b", (2, 2), 1, {}),
    "opt41": ("opt-proxy", (4, 1), 2, {}),
    "opt14": ("opt-proxy", (1, 4), 2, {}),
    "nofsdp": ("opt-proxy", (2, 2), 2, {"parallel.fsdp": False}),
    "int8": ("opt-proxy", (2, 2), 2, {"parallel.int8_optimizer_state": True}),
    "accum": ("opt-proxy", (2, 2), 2, {"train.grad_accum": 2}),
    "sp": ("opt-proxy", (2, 2), 2, {"parallel.sp": True}),
    "sp_int8": ("opt-proxy", (2, 2), 2,
                {"parallel.sp": True, "parallel.int8_optimizer_state": True}),
    "minicpm": ("minicpm-2b", (1, 4), 2, {}),
    "whisper": ("whisper-large-v3", (2, 2), 2, {}),
    "whisper_sp": ("whisper-large-v3", (2, 2), 2, {"parallel.sp": True}),
    # 8 patch embeddings before 16 tokens: 24 positions, sequence-sharded;
    # 3 before 16 on 1x4: 19 stay whole, and 2 kv-heads keep attention
    # whole
    "pixtral_sp": ("pixtral-12b", (2, 2), 2, {"parallel.sp": True}),
    "pixtral_sp19": ("pixtral-12b", (1, 4), 2, {"parallel.sp": True}),
    "moe": ("olmoe-1b-7b", (2, 2), 1, {}),
    "moe_global": ("olmoe-1b-7b", (2, 2), 1,
                   {"parallel.ep_local_dispatch": False}),
    "moe_global41": ("olmoe-1b-7b", (4, 1), 1,
                     {"parallel.ep_local_dispatch": False}),
    "intern14": ("internlm2-1.8b", (1, 4), 1, {}),
    "rgemma14": ("recurrentgemma-9b", (1, 4), 2, {}),
    "rgemma22_sp": ("recurrentgemma-9b", (2, 2), 2, {"parallel.sp": True}),
    # deepseek cut to its one dense layer: 1 MLA head a rank, a dense MTP
    # layer; at full smoke depth on 2x2 under sp: 2 heads and 4 experts a
    # rank, a routed MTP layer
    "ds14": ("deepseek-v3-671b", (1, 4), 2, {"model.num_layers": 1}),
    "ds22_sp": ("deepseek-v3-671b", (2, 2), 1, {"parallel.sp": True}),
    "mamba14": ("falcon-mamba-7b", (1, 4), 2, {}),
    "mamba22": ("falcon-mamba-7b", (2, 2), 2, {}),
    "mamba22_sp": ("falcon-mamba-7b", (2, 2), 2, {"parallel.sp": True}),
    "moe14": ("olmoe-1b-7b", (1, 4), 1, {}),
    "moe22_sp": ("olmoe-1b-7b", (2, 2), 1, {"parallel.sp": True}),
}
# the cases whose gathered state is checkpointed and restored onto 2x2
CKPT_CASES = ("mamba14", "rgemma14", "ds14")
COMPRESS_STEPS = 6
# train(mesh=): the steps of the whole run and the batch at which rank 1's
# stream sends it SIGTERM
TRAIN_STEPS, SIGTERM_AT = 6, 3


def case_config(name: str):
    """A case's configuration, as the pytest process builds it."""
    from repro_torch.configs import get_config
    arch, _, _, over = CASES[name]
    cfg = get_config(arch, smoke=True)
    cfg.model.dtype = "float32"
    for key, v in over.items():
        sect, field = key.split(".")
        setattr(getattr(cfg, sect), field, v)
    return cfg


def train_config(ckpt_dir: str):
    """``train(mesh=)``'s configuration, as the pytest process builds it."""
    from repro_torch.configs import get_config
    cfg = get_config("opt-proxy", smoke=True)
    cfg.model.dtype = "float32"
    cfg.train.steps = TRAIN_STEPS
    cfg.train.global_batch_size = 8
    cfg.train.seq_len = 16
    cfg.train.warmup_steps = 2
    cfg.train.ckpt_dir = ckpt_dir
    cfg.train.ckpt_every = 100
    cfg.train.ckpt_async = False
    return cfg


def arrays(prefix: str, tree) -> dict:
    from repro_torch.distributed.checkpoint import tree_paths
    return {f"{prefix}/{k}": v.detach().cpu().numpy()
            for k, v in tree_paths(tree)}


def state_of(inp, prefix: str, like):
    """A TrainState like ``like`` from ``<prefix>/<path>`` arrays."""
    from repro_torch.distributed.checkpoint import restore_like
    n = len(prefix) + 1
    return restore_like({k[n:]: torch.from_numpy(inp[k])
                         for k in inp.files if k.startswith(prefix + "/")},
                        like)


def batches_of(inp, prefix: str) -> list:
    out, i = [], 0
    while f"{prefix}/{i}/tokens" in inp.files:
        out.append({k.rsplit("/", 1)[1]: torch.from_numpy(inp[k])
                    for k in inp.files if k.startswith(f"{prefix}/{i}/")})
        i += 1
    return out


def compress_checks(inp, out: dict) -> None:
    from repro_torch.distributed.compression import compress_psum
    g = torch.from_numpy(inp["compress/g"][dist.get_rank()])
    for method in ("none", "bf16", "int8"):
        err = None
        for s in range(COMPRESS_STEPS):
            gs = g * (1.0 + 0.3 * s)
            red, err = compress_psum({"g": gs}, None, method, err)
            out[f"compress/{method}/{s}/red"] = red["g"].numpy()
            if err is not None:
                out[f"compress/{method}/{s}/err"] = err["g"].numpy()


def gpipe_check(inp, out: dict) -> None:
    from repro_torch.distributed.pipeline_parallel import (gpipe_forward,
                                                           make_stage_fn,
                                                           stack_stages)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(pod=2, data=2, model=1)
    ws = torch.from_numpy(inp["gpipe/ws"])
    x = torch.from_numpy(inp["gpipe/x"])
    stages, per = stack_stages([{"w": w} for w in ws], 2)
    stage_fn = make_stage_fn(lambda p, h: torch.tanh(h @ p["w"]), per)
    out["gpipe/y"] = gpipe_forward(mesh, stage_fn, stages, x,
                                   n_microbatches=4, axis="pod").numpy()


def step_checks(inp, meshes, out: dict, meta: dict, d: str) -> None:
    from repro_torch.distributed import sharding
    from repro_torch.distributed.checkpoint import (Checkpointer,
                                                    map_with_path)
    from repro_torch.models import transformer as T
    from repro_torch.models.linear import Tap, dense
    from repro_torch.training import train_step as TS
    for name, (_, shape, steps, _) in CASES.items():
        cfg = case_config(name)
        mesh = meshes[shape]
        state = state_of(inp, f"{name}/state", TS.init_train_state(cfg,
                                                                   "cpu"))
        rules = sharding.make_rules(mesh, cfg.parallel)
        specs = sharding.train_state_pspecs(state, rules,
                                            fsdp=cfg.parallel.fsdp)
        state = map_with_path(sharding.local(state, specs, mesh),
                              lambda _, t: t.clone())
        step = TS.make_sharded_train_step(cfg, rules, specs)
        metrics, widths = [], {}

        def width(layer, x):
            widths.setdefault(layer, set()).add(int(x.shape[-1]))

        def proj_out(p, x, name="", reduce=None):
            y = dense(p, x, name, reduce)
            if name == "mtp.proj":
                width("mtp.proj:out", y)
            return y
        for i, batch in enumerate(batches_of(inp, f"{name}/batch")[:steps]):
            with contextlib.ExitStack() as tap:
                if i == 0:      # the row-parallel products' input widths
                    tap.enter_context(Tap(width))
                    tap.enter_context(_patched(T, "dense", proj_out))
                state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        meta[f"{name}/widths"] = {k: sorted(v) for k, v in widths.items()
                                  if k.endswith((".o", ".down", ".out",
                                                 ":out"))}
        whole = sharding.gather(state, specs, mesh)
        out.update(arrays(f"{name}/out", whole))
        meta[name] = metrics
        if name in CKPT_CASES:
            ck = Checkpointer(os.path.join(d, f"ck_{name}"))
            if dist.get_rank() == 0:
                ck.save(steps, whole, {"step": steps})
                ck.wait()
            dist.barrier()
            rules22 = sharding.make_rules(meshes[(2, 2)], cfg.parallel)
            like = TS.init_train_state(cfg, "cpu")
            specs22 = sharding.train_state_pspecs(like, rules22)
            blocks, _ = ck.restore(like, shardings=(specs22,
                                                    meshes[(2, 2)]))
            out.update(arrays(f"{name}/restored22", sharding.gather(
                blocks, specs22, meshes[(2, 2)])))


@contextlib.contextmanager
def _patched(mod, name: str, fn):
    orig = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, orig)


class _SigtermAt:
    """A ``MarkovLM`` whose stream sends this process SIGTERM as it makes
    batch ``at`` (on one rank only: the trainer reduces the flag)."""

    def __init__(self, data, at):
        self.data, self.at = data, at

    def batch(self, *a, **kw):
        if self.data.step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.data.batch(*a, **kw)

    def state(self):
        return self.data.state()

    def restore(self, st):
        self.data.restore(st)


def trainer_checks(d: str, meshes, out: dict, meta: dict) -> None:
    from repro_torch.data import MarkovLM
    from repro_torch.distributed import sharding
    from repro_torch.distributed.checkpoint import Checkpointer
    from repro_torch.training import train_step as TS
    from repro_torch.training.trainer import train
    rank = dist.get_rank()
    a, b = os.path.join(d, "ck_22"), os.path.join(d, "ck_41")
    data = MarkovLM(128, seed=0)
    first = train(train_config(a), _SigtermAt(data, SIGTERM_AT)
                  if rank == 1 else data, device="cpu", mesh=meshes[(2, 2)],
                  verbose=False)
    meta["stopped"] = len(first["history"])
    out.update(arrays("train/stopped", first["state"]))
    dist.barrier()
    if rank == 0:
        shutil.copytree(a, b)
    dist.barrier()
    resumed = train(train_config(b), MarkovLM(128, seed=0), device="cpu",
                    mesh=meshes[(4, 1)], verbose=False)
    meta["resumed_steps"] = [h["step"] for h in resumed["history"]]
    meta["resumed_loss"] = [h["loss"] for h in resumed["history"]]
    out.update(arrays("train/resumed", resumed["state"]))
    # the 4x1 run's checkpoint restored onto 2x2
    cfg = train_config(b)
    like = TS.init_train_state(cfg, "cpu")
    mesh = meshes[(2, 2)]
    specs = sharding.train_state_pspecs(like, sharding.make_rules(
        mesh, cfg.parallel))
    blocks, extra = Checkpointer(b).restore(like, shardings=(specs, mesh))
    meta["restored_step"] = extra["step"]
    out.update(arrays("train/restored22", sharding.gather(blocks, specs,
                                                          mesh)))


class _LogSaves:
    """Wraps ``Checkpointer.save``: each call appends its step to
    ``log``."""

    def __init__(self, log: str):
        from repro_torch.distributed.checkpoint import Checkpointer
        orig = Checkpointer.save

        def save(ck, step, *a, **kw):
            with open(log, "a") as f:
                f.write(f"{step}\n")
            return orig(ck, step, *a, **kw)
        Checkpointer.save = save


def main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    inp = np.load(os.path.join(d, "inputs.npz"))
    out, meta = {}, {}
    meshes = {s: make_host_mesh(data=s[0], model=s[1])
              for s in ((2, 2), (4, 1), (1, 4))}
    compress_checks(inp, out)
    gpipe_check(inp, out)
    step_checks(inp, meshes, out, meta, d)
    _LogSaves(os.path.join(d, f"saves.{rank}"))    # train(mesh=)'s saves
    trainer_checks(d, meshes, out, meta)
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def launcher(log: str, argv) -> None:
    from repro_torch.launch import train
    _LogSaves(f"{log}.{os.environ['RANK']}")
    torch.set_num_threads(1)
    train.main(argv)


if __name__ == "__main__":
    if sys.argv[1] == "launcher":
        launcher(sys.argv[2], sys.argv[3:])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
