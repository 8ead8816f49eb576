"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. All
sources build in parallel (one ``nvcc`` per source, started together) at
the first use of any kernel, into ``build/kernels/<hash>/`` at the
repository root, keyed by a hash of the sources and flags; a later process
finds the libraries there and skips the build. ``ptxas -v`` output (the
registers, shared memory and spills of each kernel) is kept beside each
library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("hessian_accum", "gptq_block", "rpiq_block", "w4a16_matmul",
           "int8_kv_attention", "int8_kv_attention_r16", "quant_pack",
           "selective_scan", "selective_scan_bwd")
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the sweep kernels and the scan's state update must round `a - b*c` and
# `a*h + b*c` like the plain version: no contraction into a fused
# multiply-add (the sweeps' dot products call fmaf); the scan's backward
# recomputes the forward's states bitwise
EXTRA_FLAGS = {"gptq_block": ["-fmad=false"], "rpiq_block": ["-fmad=false"],
               "selective_scan": ["-fmad=false"],
               "selective_scan_bwd": ["-fmad=false"]}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _flags(name: str):
    return BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def build_dir() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / f"{name}.cu").read_bytes())
        h.update(" ".join(_flags(name)).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet; returns the directory.

    Raises with the compiler's output when a build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def ptxas_report() -> Dict[str, str]:
    """{source: the ptxas lines (registers, smem, spills)} of the build."""
    out = build_dir()
    rep = {}
    for name in SOURCES:
        log = out / f"{name}.log"
        text = log.read_text() if log.exists() else ""
        rep[name] = "\n".join(
            ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln)
    return rep


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources first."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _declare(name, lib)
            _LIBS[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "hessian_accum": {"hessian_accum_launch": [p, p, i, i, i, p]},
        "w4a16_matmul": {
            "w4a16_matmul_f32_launch": [p, p, p, p, p, i, i, i, i, p],
            "w4a16_matmul_bf16_cc_launch": [p, p, p, p, p, i, i, i, i, p],
            "w4a16_matmul_bf16_launch": [p] * 6 + [i] * 7 + [p]},
        "gptq_block": {
            "gptq_block_launch": [p] * 6 + [i] * 8 + [p]},
        "rpiq_block": {
            "rpiq_block_launch": [p] * 12 + [i] * 6 + [f] + [i] * 4 + [p],
            "rpiq_block_yq_in_smem": [i, i, i, i],
            "rpiq_block_wide_launch": [p] * 13 + [i] * 6 + [f] + [i] * 2
            + [p],
            "rpiq_block_wide_partials": [i, i]},
        "int8_kv_attention": {
            "int8_kv_attention_f32_launch": [p] * 7 + [i] * 8 + [p] * 2
            + [f, p],
            "int8_kv_attention_bf16_launch": [p] * 7 + [i] * 8 + [p] * 2
            + [f, p]},
        "int8_kv_attention_r16": {
            "int8_kv_attention_r16_f32_launch": [p] * 7 + [i] * 7
            + [p] * 2 + [f, p],
            "int8_kv_attention_r16_bf16_launch": [p] * 7 + [i] * 7
            + [p] * 2 + [f, p]},
        "quant_pack": {
            "quant_pack_f32_launch": [p] * 4 + [i] * 3 + [p],
            "quant_pack_bf16_launch": [p] * 4 + [i] * 3 + [p]},
        "selective_scan": {
            "selective_scan_f32_launch": [p] * 9 + [i] * 4 + [p],
            "selective_scan_bf16_launch": [p] * 9 + [i] * 4 + [p],
            "selective_scan_channels_per_block": [],
            "selective_scan_max_state": []},
        "selective_scan_bwd": {
            "selective_scan_bwd_f32_launch": [p] * 20 + [i] * 4 + [p],
            "selective_scan_bwd_bf16_launch": [p] * 20 + [i] * 4 + [p],
            "selective_scan_bwd_channels_per_block": [],
            "selective_scan_bwd_max_state": []},
    }[name]
    for fn, args in sigs.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
