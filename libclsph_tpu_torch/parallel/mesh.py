"""The 1-D mesh of the sharded substep: one process (rank) per shard.

PyTorch counterpart of ``libclsph_tpu/parallel/mesh.py``. JAX drives
every shard of its "dp" axis from one controller through ``shard_map``;
here each shard is a rank of ``torch.distributed``, and the collectives
of the JAX module map one to one onto methods of :class:`Mesh`:

* ``lax.pmin`` / ``lax.pmax`` -> :meth:`Mesh.all_reduce_max` (a minimum
  is the maximum of the negated values, so one call carries both);
* ``lax.all_gather(tiled=True)`` -> :meth:`Mesh.all_gather` (the ranks'
  tensors concatenated in rank order);
* ``lax.ppermute`` over the forward / backward ring ->
  :meth:`Mesh.ring` (``batch_isend_irecv``);
* ``lax.axis_index`` -> :attr:`Mesh.rank`.

Several tensors of one collective travel as one flat float32 buffer, so
a substep pays one call per exchange, not one per field.

Backends: ``gloo`` on the CPU and wherever ranks share a card, ``nccl``
only where each rank owns a card (:func:`choose_backend` refuses two
ranks on one card under NCCL). Gloo's send and receive take host
tensors only (its all_reduce, broadcast and all_gather take CUDA tensors:
``experiments/torch_gloo_cuda_probe.py``), so under ``gloo`` every
collective of a CUDA rank is staged explicitly through pinned host
buffers here, one path for all, and the staged bytes are counted beside
the collectives (:meth:`Mesh.read_stats`); the kernels still run on the
card.

:func:`launch` spawns the ranks (``torch.multiprocessing``, ``spawn``),
each running a function of the package, with a fresh ``file://`` store
per launch and a time limit that kills the ranks and raises when one
fails or hangs. The CUDA kernels are built once, in the parent, before
the ranks start.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..core import morton

AXIS = "dp"
# seconds a rank waits for the others at init and in any collective
COLLECTIVE_TIMEOUT_S = 120.0
# seconds a launch may run before its ranks are killed (None: no limit)
LAUNCH_TIMEOUT_S = 1800.0
BACKENDS = ("gloo", "nccl")


def choose_backend(world: int, device_type: str, cards: int, backend=None) -> str:
    """The backend for ``world`` ranks on ``device_type`` with ``cards``
    CUDA devices: ``nccl`` where each rank owns a card, else ``gloo``
    (the CPU, and ranks that share a card). An explicit ``backend`` is
    checked: NCCL needs CUDA and one card a rank."""
    if backend is None:
        return "nccl" if device_type == "cuda" and world <= cards else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("the nccl backend needs CUDA ranks; use gloo on the CPU")
        if world > cards:
            raise ValueError(
                f"the nccl backend cannot put {world} ranks on {cards} card(s): NCCL needs "
                "one card a rank; ranks that share a card run over gloo")
    return backend


def _flat(tensors):
    """One float32 buffer of ``tensors`` and the shapes to split it by."""
    shapes = [tuple(t.shape) for t in tensors]
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]), shapes


def _split(buf, shapes, lead: int = 0):
    """Split flat ``buf`` back into ``shapes``; with ``lead`` > 0, ``buf``
    holds ``lead`` rank copies (lead, sum) and each part comes back with
    its ranks concatenated along dim 0."""
    sizes = [int(np.prod(s)) for s in shapes]
    parts = torch.split(buf, sizes, dim=-1)
    if not lead:
        return [p.reshape(s) for p, s in zip(parts, shapes)]
    return [p.reshape((lead * s[0],) + s[1:]) if s else p.reshape(lead)
            for p, s in zip(parts, shapes)]


class Mesh:
    """One rank's view of the 1-D mesh: ``rank`` (``axis_index``),
    ``world`` (the shard count), the rank's ``device`` and the process
    group's ``backend``. Counts each collective it runs (calls and the
    bytes that arrive on this rank) and the bytes staged through host
    buffers."""

    def __init__(self, rank: int, world: int, device, backend: str):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.reset_stats()

    def reset_stats(self) -> None:
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.staged_bytes = 0

    def read_stats(self) -> dict:
        return dict(calls=dict(self.calls), bytes=dict(self.bytes),
                    staged_bytes=self.staged_bytes)

    def _count(self, op: str, nbytes: int) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + nbytes

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the collective sends it: a pinned host copy when
        staged."""
        if not self.staged:
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.staged_bytes += host.numel() * host.element_size()
        return host

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        """A collective's result back on the rank's device."""
        if not self.staged:
            return t
        self.staged_bytes += t.numel() * t.element_size()
        return t.to(self.device)

    def _new(self, shape, dtype=torch.float32) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    # ---- collectives ----------------------------------------------------
    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the ranks (``lax.pmax``)."""
        buf = self._out(t) if self.staged else t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        self._count("all_reduce", buf.numel() * buf.element_size())
        return self._in(buf)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along dim 0 in rank order
        (``lax.all_gather(tiled=True)``)."""
        return self.all_gather_many([t])[0]

    def all_gather_many(self, tensors) -> list:
        """:meth:`all_gather` of several tensors in one collective (as one
        flat float32 buffer; integer and bool tensors come back as float32
        and must hold values that float32 carries exactly)."""
        flat, shapes = _flat(tensors)
        send = self._out(flat)
        recv = self._new((self.world, flat.numel()))
        dist.all_gather(list(recv.unbind(0)), send)
        self._count("all_gather", recv.numel() * recv.element_size())
        return _split(self._in(recv), shapes, lead=self.world)

    def ring(self, tensors, r_fwd: int, r_bwd: int) -> list:
        """``r_fwd`` hops of ``tensors`` forward over the ring (rank r
        sends to r+1) and then ``r_bwd`` hops backward (``lax.ppermute``):
        forward hop k delivers rank (r-k)'s tensors, backward hop k rank
        (r+k)'s. Returns one list of tensors per hop, forward hops first."""
        flat, shapes = _flat(tensors)
        received = []
        for hops, step in ((r_fwd, 1), (r_bwd, -1)):
            buf = self._out(flat)
            for _ in range(hops):
                recv = self._new(flat.shape)
                ops = [dist.P2POp(dist.isend, buf, (self.rank + step) % self.world),
                       dist.P2POp(dist.irecv, recv, (self.rank - step) % self.world)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
                self._count("ring", recv.numel() * recv.element_size())
                received.append(_split(self._in(recv), shapes))
                buf = recv
        return received

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (``t`` must have the same
        shape and dtype on all of them)."""
        buf = self._out(t) if self.staged else t.clone()
        dist.broadcast(buf, src)
        self._count("broadcast", buf.numel() * buf.element_size())
        return self._in(buf)

    def barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.all_reduce_max(torch.zeros(1, device=self.device))


def check_collectives(mesh: Mesh) -> dict:
    """A rank body that runs every collective of :class:`Mesh` once on
    values made from the rank, on its device, and returns what arrived
    (host arrays) with the counts: the launcher's and the backend's own
    check. Rank r sends r's values; the ring runs its full coverage,
    (world + 1) // 2 hops forward and the rest backward."""
    dev, r = mesh.device, float(mesh.rank)
    fwd = mesh.world // 2
    hops = mesh.ring([torch.full((2,), r, device=dev)], fwd, mesh.world - 1 - fwd)
    many = mesh.all_gather_many([torch.full((1, 2), r, device=dev),
                                 torch.arange(3, device=dev, dtype=torch.int32) + mesh.rank])
    return dict(
        max=mesh.all_reduce_max(torch.tensor([r, -r], device=dev)).cpu().numpy(),
        gather=mesh.all_gather(torch.full((2, 3), r, device=dev)).cpu().numpy(),
        many=[t.cpu().numpy() for t in many],
        ring=[hop[0].cpu().numpy() for hop in hops],
        broadcast=mesh.broadcast(torch.full((2,), r + 1.0, device=dev)).cpu().numpy(),
        stats=mesh.read_stats())


def morton_partition(position: np.ndarray, n_shards: int) -> np.ndarray:
    """Host-side global spatial decomposition (mesh.py:29-51): the stable
    permutation that Morton-orders the particles over their own bounding
    box at 10 bits an axis, so each shard's contiguous rows own a compact
    region. ``n_shards`` is unused, as in the JAX function. The coordinates
    are computed in float32 with NumPy exactly as there."""
    pos = np.asarray(position, dtype=np.float32)
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    cell = np.maximum((hi - lo) / 1023.0, 1e-12)
    coords = np.clip(((pos - lo) / cell), 0, 1023).astype(np.uint32)
    c = torch.from_numpy(coords.astype(np.int32))
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).numpy()
    return np.argsort(codes, kind="stable")


def shard_rows(n_padded: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous rows of a padded state (the counterpart
    of ``particle_sharding``'s ``P("dp")`` layout)."""
    n_local = n_padded // world
    return slice(rank * n_local, (rank + 1) * n_local)


# ---- the launcher -----------------------------------------------------------

def _rank_main(rank, world, workdir, device_type, backend, threads, body, args):
    """A rank's process: join the group, run ``body(mesh, *args)``, write
    its result (or its traceback) into ``workdir``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(workdir, "store"), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = body(Mesh(rank, world, device, backend), *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        # the parent reads the traceback and stops the other ranks
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(body, world: int, args=(), device: str = "cuda", backend=None,
           timeout: float | None = LAUNCH_TIMEOUT_S, threads=None, log=None) -> list:
    """Run ``body(mesh, *args)`` on ``world`` ranks and return their
    results in rank order. ``body`` must be a module-level function (the
    ranks are spawned, so it is pickled by name). ``device`` "cuda" (the
    default) or "cpu": rank r takes ``cuda:(r % device_count)``; ranks that share a
    card run over gloo and one line says so (``log``, default print).
    ``threads``: torch threads a rank (default: the host's cores shared
    out on the CPU, torch's own on CUDA). Raises when a rank fails (its
    traceback in the message) or when the launch outlives ``timeout``
    seconds (``None``: no limit; a hung collective still fails its rank
    after ``COLLECTIVE_TIMEOUT_S``); either way every rank is stopped
    first."""
    log = log or (lambda msg: print(msg, flush=True))
    device_type = torch.device(device).type
    cards = 0
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        cards = torch.cuda.device_count()
        from ..ops.kernels import build

        build.build()  # once, here, not in every rank
    elif device_type != "cpu":
        raise ValueError(f"launch: unsupported device {device}")
    backend = choose_backend(world, device_type, cards, backend)
    if device_type == "cuda" and world > cards:
        log(f"mesh: {world} ranks share {cards} card(s) over {backend}; collectives are "
            "staged through host buffers and the times measure no multi-GPU scaling")
    if threads is None and device_type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // world)
    workdir = tempfile.mkdtemp(prefix="sph_mesh_")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, workdir, device_type, backend, threads, body,
                               tuple(args)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(workdir, procs, failed))
            if all(p.exitcode == 0 for p in procs):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"launch: ranks still running after {timeout:.0f} s "
                                   f"(exit codes {[p.exitcode for p in procs]})")
            time.sleep(0.05)
        results = []
        for r in range(world):
            with open(os.path.join(workdir, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(10)
        shutil.rmtree(workdir, ignore_errors=True)


def _failure(workdir, procs, failed) -> str:
    lines = [f"launch: rank(s) {failed} failed (exit codes {[p.exitcode for p in procs]})"]
    for r in failed:
        path = os.path.join(workdir, f"error{r}.txt")
        if os.path.exists(path):
            lines.append(f"--- rank {r} ---\n" + open(path).read())
    return "\n".join(lines)
