"""Process-group set-up and the collectives of the sharded smoother.

One process per rank (``torch.distributed``); rank r owns a contiguous
slice of the padded block stack. The JAX package's ``shard_map`` body
becomes what every rank runs on its own slice:

- ``exchange``: the point-to-point halo exchange of an ``Exchange``
  schedule (``jax.lax.ppermute`` per ring offset in the JAX package): for
  each offset ``o`` rank r sends the values its offset-``o`` neighbour
  needs to ``(r + o) % D`` and receives from ``(r - o) % D``, one
  ``batch_isend_irecv`` per offset, all posted before the first wait;
- ``pdot``: a local sum and one ``all_reduce`` (``psum``), left on the
  device (no host read);
- ``all_gather_stack``: the whole block stack on every rank.

Backends. ``nccl`` only when every rank has a CUDA device of its own
(device ``cuda:{local_rank}``); ``gloo`` when ranks share a card or run on
the CPU. Gloo's send and receive take CPU tensors only, and its
``all_gather`` too, so on CUDA tensors those stage their data through host
memory (one copy each way an exchange) while the compute stays on the card; its ``all_reduce`` takes CUDA
tensors directly. The backend is the caller's choice, never a fallback.

Counterpart of ``make_exchange`` and ``pdot`` in
turbomesh_tpu/parallel/shard.py.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

#: collective calls since the last reset, in this process (the sharded
#: layer's metrics: exchanges and all_reduces per FGMRES iteration), and
#: the host seconds spent inside them (waits for the device and the
#: partners included)
EXCHANGES = 0
ALL_REDUCES = 0
COLLECTIVE_S = 0.0

#: seconds a collective may wait before the group gives up
TIMEOUT_S = 600


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))


def world_size() -> int:
    """The group's size, or torchrun's WORLD_SIZE before the group exists
    (1 outside torchrun)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def rank_device(device) -> torch.device:
    """This rank's torch device for a requested ``device``: "cuda" maps to
    ``cuda:{local_rank % device_count}`` (each rank its own card when there
    are enough, else ranks share them); anything else stays as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available")
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def backend_for(device, world: int) -> str:
    """``nccl`` when the ranks run on CUDA and each has a card of its own,
    ``gloo`` otherwise (ranks sharing a card, or the CPU)."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


def ensure_group(device) -> None:
    """Initialise the default process group if none exists: from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR) when it is
    there, otherwise a world of 1 on an in-memory store."""
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    mine = rank_device(device)
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        _init(backend_for(device, world), mine, timeout=timeout,
              init_method="env://")
    else:
        _init(backend_for(device, 1), mine, timeout=timeout,
              store=dist.HashStore(), rank=0, world_size=1)


def _init(backend, device, **kwargs):
    device = torch.device(device)
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, **kwargs)


def _staged(t: torch.Tensor) -> bool:
    """Does this tensor go through host memory for gloo's point-to-point
    calls and all_gather?"""
    return t.is_cuda and dist.get_backend() == "gloo"


def exchange(ex, send, Xf: torch.Tensor) -> torch.Tensor:
    """VAL table of an ``Exchange``: ``send`` maps each offset o to this
    rank's (L_o,) local flat indices (``ex.send_idx[o][rank]``); Xf is the
    rank's flat field (P, C). Every rank must call this with the same
    schedule. Each nonzero offset is one batched send/receive pair, all
    posted before the first wait (a rank pair meets at one offset only,
    so the messages cannot cross); under gloo on a card, the outgoing
    chunks go to the host in one copy and the incoming come back in one."""
    global EXCHANGES, COLLECTIVE_S
    EXCHANGES += 1
    t0 = time.perf_counter()
    chunks = [Xf[send[o]] for o in ex.offsets]
    remote = [k for k, o in enumerate(ex.offsets) if o != 0]
    if remote:
        D = dist.get_world_size()
        r = dist.get_rank()
        lens = [chunks[k].shape[0] for k in remote]
        out = torch.cat([chunks[k] for k in remote])
        if _staged(Xf):
            out = out.cpu()
        inc = torch.empty_like(out)
        reqs = []
        for k, o_out, o_in in zip(remote, out.split(lens), inc.split(lens)):
            o = ex.offsets[k]
            reqs += dist.batch_isend_irecv([
                dist.P2POp(dist.isend, o_out, (r + o) % D),
                dist.P2POp(dist.irecv, o_in, (r - o) % D)])
        for req in reqs:
            req.wait()
        for k, got in zip(remote, inc.to(Xf.device).split(lens)):
            chunks[k] = got
    out = torch.cat(chunks, dim=0)
    COLLECTIVE_S += time.perf_counter() - t0
    return out


def pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Global dot product: a local sum, then one all_reduce (every rank
    gets the same value)."""
    global ALL_REDUCES, COLLECTIVE_S
    ALL_REDUCES += 1
    s = torch.sum(a * b)
    t0 = time.perf_counter()
    dist.all_reduce(s)
    COLLECTIVE_S += time.perf_counter() - t0
    return s


def all_gather_stack(t: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0, in rank order."""
    stage = _staged(t)
    src = t.cpu() if stage else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    out = torch.cat(parts, dim=0)
    return out.to(t.device) if stage else out


# ---------------------------------------------------------------------------
# local worlds: one process per rank on this machine
# ---------------------------------------------------------------------------


def _rank_main(rank, world, backend, device, store_path, fn, args, results):
    """Entry point of a spawned rank: join the group, run fn(*args), put
    (rank, ok, result or traceback) on the results queue."""
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        store = dist.FileStore(store_path, world)
        _init(backend, rank_device(device), store=store, rank=rank,
              world_size=world,
              timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, backend: str, device, args=()) -> list:
    """Run ``fn(*args)`` on ``world`` new processes that form one process
    group (``backend`` over a FileStore in a fresh temporary directory, so
    concurrent worlds never share a port or a file), and return the
    results in rank order. ``fn`` must be importable (a module-level
    function of this package); ``device`` "cuda" gives rank r
    ``cuda:{r % device_count}``. Raises with the first failed rank's
    traceback, or when a rank dies without a result (a collective that
    waits TIMEOUT_S for a partner fails its rank); no process outlives
    the call."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="turbomesh_dist_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, device,
                               os.path.join(tmp, "store"), fn, args, results))
             for r in range(world)]
    out = [None] * world
    try:
        for p in procs:
            p.start()
        got = 0
        while got < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} exited with code "
                                           f"{p.exitcode}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            got += 1
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return out
