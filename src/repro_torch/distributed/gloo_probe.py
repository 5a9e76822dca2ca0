"""Which gloo collectives take CUDA tensors, and what staging through the
host costs (card only).

Ranks that share one card cannot use NCCL, so they use gloo, whose CUDA
support differs by collective and by PyTorch version.  This spawns a gloo
world of ``--ranks`` processes on card 0 and, on every rank, tries each
collective the distributed layer could use on CUDA tensors directly,
reporting whether it ran and gave the right values; then it times
:func:`repro_torch.distributed.comm.sum_fixed` and ``all_gather_shards``
(host-staged) at a scalar and at a halo shard of ``--shard`` floats, and
their parts: gloo alone on host tensors, the copies alone, and gloo's own
CUDA path (µs a call, mean of 50 after one warm call)::

    python -m repro_torch.distributed.gloo_probe [--ranks 4] [--shard 524288] [--threads 2]

Prints one JSON line (rank 0's view).  The layer stages every gloo
collective through the host whatever this finds, so a change in gloo's
CUDA support changes no result.
"""

from __future__ import annotations

import argparse
import json
import time

__all__ = ["main"]


def _try(name, fn) -> dict:
    try:
        ok = bool(fn())
        return {"collective": name, "ran": True, "right": ok}
    except Exception as e:  # a refusal is the finding, not a failure
        return {"collective": name, "ran": False, "error": f"{type(e).__name__}: {e}"[:200]}


def _rank(shard: int) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import comm

    rank, size = comm.world()
    dev = torch.device("cuda", 0)
    x = torch.full((4,), float(rank + 1), device=dev)
    want_sum = float(sum(range(1, size + 1)))

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x)
        return all(float(p[0]) == r + 1 for r, p in enumerate(parts))

    def all_gather_into_tensor():
        out = torch.empty(size * 4, device=dev)
        dist.all_gather_into_tensor(out, x)
        return float(out[4 * (size - 1)]) == size

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return float(y[0]) == want_sum

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return float(y[0]) == 1.0

    found = [_try(n, f) for n, f in (("all_gather", all_gather),
                                     ("all_gather_into_tensor",
                                      all_gather_into_tensor),
                                     ("all_reduce", all_reduce),
                                     ("broadcast", broadcast))]
    dist.barrier()

    def timed(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    scalar = torch.ones((), device=dev)
    halo = torch.ones(shard, device=dev)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t)

    cpu_scalar, cpu_halo = torch.ones(1), torch.ones(shard)
    times = {
        # the layer's staged collectives
        "sum_fixed_scalar_us": timed(lambda: comm.sum_fixed(scalar)),
        "all_gather_shards_us": timed(lambda: comm.all_gather_shards(halo)),
        # their parts: gloo alone on host tensors, the copies alone
        "host_scalar_all_gather_us": timed(lambda: gather(cpu_scalar)),
        "host_shard_all_gather_us": timed(lambda: gather(cpu_halo)),
        "scalar_round_trip_copy_us": timed(lambda: scalar.cpu().to(dev)),
        "shard_down_copy_us": timed(lambda: halo.cpu()),
        # gloo's own CUDA path
        "native_scalar_all_gather_us": timed(lambda: gather(scalar.reshape(1))),
        "native_shard_all_gather_us": timed(lambda: gather(halo)),
    }
    return {"rank": rank, "ranks": size, "torch": torch.__version__,
            "collectives": found, "staged": times, "shard_floats": shard}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--shard", type=int, default=524288)
    ap.add_argument("--threads", type=int, default=2,
                    help="torch threads of each rank")
    args = ap.parse_args(argv)
    from repro_torch.distributed import comm

    out = comm.run_world(_rank, args.ranks, (args.shard,), backend="gloo",
                         timeout_s=60.0, join_timeout_s=300.0,
                         threads=args.threads)
    print(json.dumps(out[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
