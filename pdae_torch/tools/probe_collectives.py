"""What the card's collectives allow, for the tensor group of data-parallel
training (``pdae_torch/parallel/dist.py``).

Starts small worlds of processes on one card (every ``LOCAL_RANK`` 0) and
prints one JSON line a process:

* ``nccl1_graph``: an NCCL group of one rank beside the gloo default group,
  its communicator built by one eager reduction, then an ``all_reduce``
  captured into a CUDA graph on a side stream and replayed three times: the
  replays' result;
* ``gloo2``: two ranks all-reducing CUDA tensors over gloo (through host
  copies): seconds per 4 MB and per 100 MB reduction;
* ``nccl2``: two ranks forming an NCCL group on the one card, which NCCL
  refuses ("Duplicate GPU detected"): the error each rank gets.

Run on a machine with a card, from the repository root:

    python -m pdae_torch.tools.probe_collectives
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

WORLDS = {"nccl1_graph": 1, "gloo2": 2, "nccl2": 2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _nccl1_graph(out):
    dist.init_process_group("gloo", init_method="env://", rank=0, world_size=1)
    group = dist.new_group(backend="nccl")
    dist.all_reduce(torch.ones(1, device="cuda"), group=group)
    torch.cuda.synchronize()
    buf = torch.zeros(1000, device="cuda")
    src = torch.arange(1000, device="cuda", dtype=torch.float32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        buf.copy_(src * 2)
        dist.all_reduce(buf, group=group)
    for _ in range(3):
        src.add_(1)
        graph.replay()
    torch.cuda.synchronize()
    out["replays_equal_twice_src"] = bool(torch.equal(buf, src * 2))


def _gloo2(out, rank, world):
    dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world)
    for name, n in (("s_per_4MB", 1 << 20), ("s_per_100MB", 100 << 18)):
        x = torch.ones(n, device="cuda") * (rank + 1)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 3


def _nccl2(out, rank, world):
    dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world,
                            device_id=torch.device("cuda", 0))
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    out["result"] = x.tolist()


def worker(mode: str) -> None:
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    out = {"mode": mode, "rank": rank, "world": world}
    try:
        if mode == "nccl1_graph":
            _nccl1_graph(out)
        elif mode == "gloo2":
            _gloo2(out, rank, world)
        else:
            _nccl2(out, rank, world)
        out["ok"] = True
    except Exception as e:       # the refusal is what the probe reports
        out["ok"], out["error"] = False, repr(e)[:600]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_collectives needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": list(torch.cuda.nccl.version()),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    for mode, world in WORLDS.items():
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pdae_torch.tools.probe_collectives", mode],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=port),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
        for p in procs:
            try:
                log = p.communicate(timeout=120)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0] + "\ntimed out"
            lines = [ln for ln in log.splitlines() if ln.startswith('{"mode"')]
            print(lines[-1] if lines else json.dumps({"mode": mode, "log": log[-1500:]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(sys.argv[1])
        sys.exit(0)
    sys.exit(main())
