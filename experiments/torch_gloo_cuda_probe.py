#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, on the card.

    python3 experiments/torch_gloo_cuda_probe.py [--ranks 2]

Ranks that share one card run the sharded substep over gloo
(``libclsph_tpu_torch/parallel/mesh.py``), whose collectives stage every
CUDA tensor through pinned host buffers. This probe tries each collective
the mesh uses directly on CUDA tensors, one launch of the ranks per
collective (a collective that gloo does not take may abort its process),
and records whether it ran and gave the right values, raised (the first
line of the error), or ended the ranks (their exit codes). Prints one
JSON line with the card and the results. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def probe_rank(mesh, op: str) -> str:
    """Collective ``op`` on CUDA tensors straight through torch.distributed."""
    import torch
    import torch.distributed as dist

    dev, r, world = mesh.device, mesh.rank, mesh.world

    def all_reduce():
        t = torch.full((4,), float(r), device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t, torch.full((4,), float(world - 1))

    def all_gather():
        parts = [torch.empty(2, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((2,), float(r), device=dev))
        return torch.cat(parts), torch.arange(world).float().repeat_interleave(2)

    def broadcast():
        t = torch.full((3,), float(r + 1), device=dev)
        dist.broadcast(t, 0)
        return t, torch.full((3,), 1.0)

    def batch_isend_irecv():
        recv = torch.empty(2, device=dev)
        ops = [dist.P2POp(dist.isend, torch.full((2,), float(r), device=dev), (r + 1) % world),
               dist.P2POp(dist.irecv, recv, (r - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv, torch.full((2,), float((r - 1) % world))

    fn = dict(all_reduce=all_reduce, all_gather=all_gather, broadcast=broadcast,
              batch_isend_irecv=batch_isend_irecv)[op]
    try:
        got, want = fn()
        torch.cuda.synchronize(dev)
    except RuntimeError as e:  # the refusal is the finding
        return "raises: " + str(e).strip().splitlines()[0][:200]
    return "ok" if torch.equal(got.cpu(), want) else f"wrong: {got.cpu().tolist()}"


OPS = ("all_reduce", "broadcast", "all_gather", "batch_isend_irecv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from bench_torch import card_line
    from libclsph_tpu_torch.parallel import mesh

    if not torch.cuda.is_available():
        sys.exit("torch_gloo_cuda_probe: needs a GPU")
    results = {}
    for op in OPS:
        try:
            results[op] = mesh.launch(probe_rank, args.ranks, args=(op,), device="cuda",
                                      backend="gloo", timeout=300, log=lambda msg: None)
        except RuntimeError as e:  # a rank ended: gloo aborted the process
            results[op] = str(e).splitlines()[0]
    print(json.dumps(dict(card=card_line(), torch=torch.__version__, ranks=args.ranks,
                          results=results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
