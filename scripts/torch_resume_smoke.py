#!/usr/bin/env python
"""Kill-and-resume smoke of the PyTorch port over real process boundaries:
the twin of ``scripts/resume_smoke.py:1-148``.

A separate ``repro_torch.launch.quantize`` process dies mid-run (the armed
``plan.stage1_executor`` fault, ``core/plan.py``, → nonzero exit), a
second invocation with ``quant.resume=auto`` picks up its step
checkpoints, and the packed artifact is bitwise-identical, leaf by leaf,
to a clean single-shot run's. The same kill and resume runs again under
``serve.kv_cache=int8`` (the serve config is part of the resume
fingerprint, so the killed and resumed runs must agree on it; the
quantize output is serve-independent, so the artifact must still equal
the clean one), and the resumed artifact is served through
``repro_torch.launch.serve`` on the int8-KV continuous path.

    PYTHONPATH=src python scripts/torch_resume_smoke.py --device cpu
    python scripts/torch_resume_smoke.py              # on the CUDA card

Every child takes ``--device`` (default: the card). ``--int8-only`` runs
the clean run and the int8-KV kill, resume and serve only (the fp16-KV
pass is the same matrix without the override). The clean run and the
first killed run start together. Every quantize child reads its
trainer checkpoint from ``train.ckpt_dir=<work>/none``, a directory that
never exists: a checkpoint left at the default ``/tmp/repro_ckpt`` is
never read. Each child's wall and each artifact's
sha256 (its integrity sidecar's) are printed, and the children's kernel
launches summed (each launcher prints its own; :data:`CHILD_LAUNCHES`);
exit 0 when every check holds.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
ARCH = "opt-proxy"
COMMON = ["--arch", ARCH, "--smoke"]
CALIB = ["quant.calib_batches=2", "quant.calib_batch_size=4",
         "quant.calib_seq_len=32"]
KV8 = ["serve.kv_cache=int8"]
# the kernel launches the children printed, summed (zero on the CPU)
CHILD_LAUNCHES: Dict[str, int] = {}


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


class Child:
    """One launcher process, started at once; :meth:`wait` checks its
    exit code (``expect_rc`` 0, or any nonzero code for 1) and prints its
    wall."""

    def __init__(self, label: str, module: str, args: List[str],
                 device: Optional[str], expect_rc: int):
        self.label, self.expect_rc = label, expect_rc
        self.cmd = [sys.executable, "-m", module, *COMMON,
                    *(["--device", device] if device else []), *args]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=_env(),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def wait(self) -> None:
        out, err = self.proc.communicate()
        wall = time.perf_counter() - self.t0
        rc = self.proc.returncode
        print(f"[torch_resume_smoke]   {self.label}: rc={rc}, wall "
              f"{wall:.2f} s", flush=True)
        for line in out.splitlines():
            if "] kernel launches: " in line:
                for k, v in json.loads(line.split(": ", 1)[1]).items():
                    CHILD_LAUNCHES[k] = CHILD_LAUNCHES.get(k, 0) + v
        if rc != self.expect_rc and not (self.expect_rc != 0 and rc):
            print(out)
            print(err, file=sys.stderr)
            raise SystemExit(
                f"expected rc={'nonzero' if self.expect_rc else 0}, got "
                f"{rc}: {' '.join(self.cmd)}")


def quantize(label: str, work: str, out_dir: str, extra: List[str],
             device: Optional[str], expect_rc: int) -> Child:
    """A ``launch.quantize`` child writing to ``out_dir``; its
    ``train.ckpt_dir`` is ``<work>/none``, which never exists, so no
    trainer checkpoint left at the default directory is read."""
    return Child(label, "repro_torch.launch.quantize",
                 ["--out", out_dir, *CALIB,
                  f"train.ckpt_dir={os.path.join(work, 'none')}", *extra],
                 device, expect_rc)


def load_leaves(path: str) -> list:
    """The artifact's leaves through the port's integrity-checked loader,
    in ``tree_paths`` order: numpy arrays, and a packed weight's shape,
    bits and group size."""
    from repro_torch.distributed.checkpoint import load_artifact, tree_paths
    return tree_paths(load_artifact(path))


def sha256_of(path: str) -> str:
    from repro_torch.distributed.checkpoint import artifact_manifest_path
    with open(artifact_manifest_path(path)) as f:
        return json.load(f)["sha256"]


def differing_leaves(ref_path: str, got_path: str) -> List[str]:
    """The paths of the leaves that differ bitwise (or in number)."""
    ref, got = load_leaves(ref_path), load_leaves(got_path)
    if [p for p, _ in ref] != [p for p, _ in got]:
        return [f"leaf paths differ: {len(ref)} vs {len(got)} leaves"]
    bad = []
    for (path, a), (_, b) in zip(ref, got):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            same = (a.dtype == b.dtype and a.shape == b.shape
                    and np.array_equal(a.reshape(-1).view(np.uint8),
                                       b.reshape(-1).view(np.uint8)))
        else:
            same = a == b
        if not same:
            bad.append(path)
    return bad


def check_bitwise(ref_path: str, got_path: str, what: str) -> None:
    bad = differing_leaves(ref_path, got_path)
    n = len(load_leaves(ref_path))
    print(f"[torch_resume_smoke] {what}: sha256 clean {sha256_of(ref_path)}"
          f", resumed {sha256_of(got_path)}", flush=True)
    if bad:
        raise SystemExit(f"{what}: {len(bad)} leaves differ after "
                         f"kill+resume: {bad[:8]}")
    print(f"[torch_resume_smoke] {what}: {n} leaves bitwise-identical "
          "after kill+resume", flush=True)


def killed(ckpt: str, what: str) -> None:
    if not any(d.startswith("step_") for d in os.listdir(ckpt)):
        raise SystemExit(f"{what}: the killed run left no step checkpoint")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="every child's --device (default: the CUDA card)")
    ap.add_argument("--int8-only", action="store_true",
                    help="the clean run and the int8-KV matrix only")
    args = ap.parse_args(argv)
    dev = args.device
    work = tempfile.mkdtemp(prefix="torch_resume_smoke_")
    try:
        ref_dir = os.path.join(work, "ref")
        name = f"{ARCH}-smoke.params.pkl"
        ref = os.path.join(ref_dir, name)
        kill = ["quant.ckpt_dir=CKPT", "quant.resume=auto",
                "faults.arm=plan.stage1_executor@4"]
        matrices = [("int8-kv matrix", KV8)]
        if not args.int8_only:
            matrices.insert(0, ("fp16-kv matrix", []))
        print("[torch_resume_smoke] the clean reference run, beside the "
              "first killed run (plan.stage1_executor@4)", flush=True)
        clean = quantize("clean run", work, ref_dir, [], dev, 0)
        resumed = {}
        for i, (what, over) in enumerate(matrices):
            out = os.path.join(work, f"res{i}")
            ckpt = os.path.join(work, f"ckpt{i}")
            arm = [a.replace("CKPT", ckpt) for a in kill]
            if i:
                print(f"[torch_resume_smoke] killed run ({what})",
                      flush=True)
            k = quantize(f"killed run ({what})", work, out, [*arm, *over],
                         dev, 1)
            if i == 0:
                clean.wait()
            k.wait()
            killed(ckpt, what)
            print(f"[torch_resume_smoke] resumed run ({what})", flush=True)
            quantize(f"resumed run ({what})", work, out,
                     [f"quant.ckpt_dir={ckpt}", "quant.resume=auto", *over],
                     dev, 0).wait()
            resumed[what] = os.path.join(out, name)
            check_bitwise(ref, resumed[what], what)
        print("[torch_resume_smoke] serve the resumed artifact on the "
              "int8-KV continuous path", flush=True)
        Child("serve", "repro_torch.launch.serve",
              ["--params", resumed["int8-kv matrix"], "--batch", "2",
               "--prompt-len", "8", "serve.max_new_tokens=6",
               "serve.scheduler=continuous", *KV8], dev, 0).wait()
        print(f"[torch_resume_smoke] the children's kernel launches: "
              f"{json.dumps(CHILD_LAUNCHES)}", flush=True)
        print("[torch_resume_smoke] OK: kill+resume matrix holds for "
              f"{' and '.join(w for w, _ in matrices)}; the resumed "
              "artifact serves", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
