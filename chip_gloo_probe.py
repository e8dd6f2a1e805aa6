#!/usr/bin/env python3
"""Which collectives this torch's gloo backend takes on CUDA tensors.

Run on a machine with one NVIDIA GPU:

    python3 chip_gloo_probe.py

Each collective runs in a gloo world of two processes of its own, both on
card 0 (a refusal can end a process): all_reduce, all_gather_into_tensor
(f32, uint8), reduce_scatter_tensor, all_to_all_single (f32, uint8, int8),
batch_isend_irecv, and the ring hop's gloo route: all_to_all_single with
one non-empty split each way (f32, int8), the calls
``byzpy_tpu_torch.parallel.collectives`` makes. Prints one line ``GLOO_CUDA_OPS {op: {"results": [rank 0, rank 1],
"exitcodes": [...], "values": [...]}}``, then the card's name and power
limit. Exits 2 without a card.
"""

import json
import queue
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ["all_reduce_f32", "all_gather_into_tensor_f32", "all_gather_into_tensor_u8",
       "reduce_scatter_tensor_f32", "all_to_all_single_f32", "all_to_all_single_u8",
       "all_to_all_single_i8", "batch_isend_irecv_f32", "shift_all_to_all_single_f32",
       "shift_all_to_all_single_i8"]


def run_op(op: str, x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    dev = x.device
    if op == "all_reduce_f32":
        y = x.clone()
        dist.all_reduce(y)
    elif op.startswith("all_gather_into_tensor"):
        src = x.to(torch.uint8) if op.endswith("u8") else x
        y = torch.empty(8 * size, device=dev, dtype=src.dtype)
        dist.all_gather_into_tensor(y, src)
    elif op == "reduce_scatter_tensor_f32":
        y = torch.empty(8 // size, device=dev)
        dist.reduce_scatter_tensor(y, x)
    elif op.startswith("shift_all_to_all_single"):
        # the ring hop: send to rank + 1, receive from rank - 1, every other
        # split empty (collectives._shift's gloo route)
        src = x if op.endswith("f32") else x.to(torch.int8)
        y = torch.empty_like(src)
        send = [8 if r == (rank + 1) % size else 0 for r in range(size)]
        recv = [8 if r == (rank - 1) % size else 0 for r in range(size)]
        dist.all_to_all_single(y, src, output_split_sizes=recv, input_split_sizes=send)
    elif op.startswith("all_to_all_single"):
        src = {"f32": x, "u8": x.to(torch.uint8), "i8": x.to(torch.int8)}[op.rsplit("_", 1)[1]]
        y = torch.empty_like(src)
        dist.all_to_all_single(y, src)
    else:
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % size),
               dist.P2POp(dist.irecv, y, (rank - 1) % size)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return y


def rank_main(rank: int, size: int, path: str, op: str, q) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}", world_size=size, rank=rank)
    x = torch.arange(8, dtype=torch.float32, device="cuda:0") + rank
    try:
        y = run_op(op, x, rank, size)
        torch.cuda.synchronize()
        q.put((rank, "ok", y.float().cpu().tolist()))
    except Exception as exc:  # noqa: BLE001 - a refusal is the probe's finding
        q.put((rank, f"{type(exc).__name__}: {str(exc)[:200]}", None))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    runs = {}
    for op in OPS:
        q = ctx.Queue()
        path = tempfile.mktemp()
        procs = [ctx.Process(target=rank_main, args=(r, 2, path, op, q)) for r in range(2)]
        for p in procs:
            p.start()
        runs[op] = (q, procs)
    out = {}
    for op, (q, procs) in runs.items():
        got = []
        for _ in range(2):
            try:
                got.append(q.get(timeout=120))
            except queue.Empty:
                got.append((None, "no answer", None))
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
        out[op] = {"results": [g[1] for g in got], "exitcodes": [p.exitcode for p in procs],
                   "values": [g[2] for g in got]}
    print("GLOO_CUDA_OPS " + json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), f"torch {torch.__version__}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
