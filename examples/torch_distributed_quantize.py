"""Distributed (row-parallel) GPTQ + RPIQ on the PyTorch port.

    PYTHONPATH=src python examples/torch_distributed_quantize.py \\
        [--world 2] [--device cpu]

The twin of ``examples/distributed_quantize.py``, importing
``repro_torch`` only. GPTQ's column loop is sequential, but rows (output
channels) are independent given the shared Cholesky factor, so the
quantizer shards rows over the ranks with no collective in the sweep.
RPIQ's closed loop is global over the rows (Γ, the early stop, the best
round), so each row shard runs its rounds and the ranks sum the per-round
Γ partials once before the bookkeeping. This example starts its own gloo
world of ``--world`` processes on a ``(data 1, model world)`` mesh and
shows both sharded stages against the single-device calls. On the card
the ranks share it (gloo; the CUDA kernels run on each rank's rows);
``--device cpu`` runs their plain versions.
"""
import argparse
import os
import sys
import tempfile
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

Cout, Cin, N = 512, 256, 1024
KW = dict(bits=4, group_size=128)


def problem(dev):
    from repro_torch.core import hessian as hess
    gen = torch.Generator()
    gen.manual_seed(0)
    w = (torch.randn((Cout, Cin), generator=gen) * 0.1).to(dev)
    x = torch.randn((N, Cin), generator=gen).to(dev)
    st = hess.accumulate(hess.init_hessian(Cin, device=dev), x)
    hd = hess.damped(st, 0.01)
    return w, x, st, hd, hess.cholesky_inverse_upper(hd)


def rank_main(rank: int, world: int, device: str, initfile: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{initfile}",
                            rank=rank, world_size=world)
    from repro_torch.core.gptq import gptq_quantize
    from repro_torch.core.rpiq import rpiq_refine
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    w, x, st, hd, u = problem(dev)
    mesh = make_host_mesh(data=1, model=world, device=dev)
    say = print if rank == 0 else (lambda *a: None)

    res1 = gptq_quantize(w, u, blocksize=128, **KW)
    sh = ops.gptq_block_sharded(w[None], u[None], mesh=mesh,
                                row_axis="model", blocksize=128, **KW)
    for a, b in zip(res1[:3], sh[:3]):
        torch.testing.assert_close(b[0], a, rtol=1e-6, atol=1e-7)
    exact = all(torch.equal(b[0], a) for a, b in zip(res1[:3], sh[:3]))
    say(f"row-sharded GPTQ == single device (exact) on {world} ranks: "
        f"{'bitwise' if exact else 'within 1e-6'}, "
        f"Σerr² {float(res1.err):.4f} / {float(sh[3][0]):.4f}")

    kw = dict(alpha=0.3, t_max=5, exact_gram=True, block_size=128, **KW)
    one = rpiq_refine(res1.w_q, w, x[-128:], hd, res1.scales, res1.zeros,
                      h_count=st.count, **kw)
    r2 = ops.rpiq_block_sharded(
        sh[0], w[None], x[None, -128:], hd[None], sh[1], sh[2],
        h_count=st.count.reshape(1), mesh=mesh, row_axis="model", **kw)
    assert int(r2[4][0]) == int(one.iters_run)
    torch.testing.assert_close(r2[0][0], one.w_q, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(r2[3][0], one.proj_loss, rtol=1e-5, atol=0)
    say(f"row-sharded RPIQ == single device: Γ "
        f"{float(r2[2][0, 0]):.2f} → {float(r2[3][0]):.2f} in "
        f"{int(r2[4][0])} rounds on {world} ranks")
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # every rank loads the kernels built here, once
        from repro_torch.kernels import build
        build.build_all()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(rank_main, args=(args.world, dev.type,
                                  os.path.join(d, "rendezvous")),
                 nprocs=args.world)


if __name__ == "__main__":
    main()
