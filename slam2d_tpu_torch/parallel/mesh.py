"""The multi-device layer over torch.distributed, the counterpart of
slam2d_tpu/parallel/mesh.py (`init_distributed`, `make_particle_mesh`).

One process per rank. A `Mesh` holds the process group, the rank, the
world size and the rank's device, and has the collectives the JAX
package's shard_map code uses, under the same names: `all_gather`
(stacked, or `tiled` along the first axis), `psum`, `pmax`, `ppermute`
(a ring shift: every rank sends to rank + shift and receives from rank -
shift, through `dist.batch_isend_irecv`) and `broadcast`, plus
`gather_to` (one rank receives every rank's tensor).

The backend is the caller's explicit choice: "nccl" for CUDA tensors on
distinct cards, "gloo" for the CPU. NCCL refuses CUDA tensors of one
card shared by two ranks; such a run raises, it is never moved to gloo.
gloo lists only broadcast and all_reduce for CUDA tensors and its
point-to-point ops read host memory, so under gloo every CUDA operand is
copied to the host and its result back, here and nowhere else, and
`Mesh.staged_bytes` counts those bytes (both ways). The compute stays on
the card.

Starting a world:

- `join(backend, world_size, rank, init_method, device)`: this process
  becomes one rank (`init_process_group` with a timeout, so ranks that
  diverge end in an error, never a hang; a world of one joins a process
  group too, so its collectives run through the backend);
- `from_env(backend, device)`: the world of `torchrun` (RANK,
  WORLD_SIZE, LOCAL_RANK set);
- `spawn(fn, world_size, backend, device, args)`: `fn(mesh, *args)` on
  every rank of a new world, processes started by the `spawn` method
  (which CUDA needs), the rendezvous a `file://` in a temporary
  directory; it returns every rank's result in rank order and re-raises
  in the caller any exception of any rank. A world of one rank runs in
  the calling process. The kernels are built before the ranks start.

Rank r runs on cuda:(r % torch.cuda.device_count()) unless the caller
names the CPU (device "cpu") or one card (e.g. "cuda:0", every rank on
it). `current()` is the mesh this process joined last.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0

_CURRENT = None


class Mesh:
    """One rank's view of a world: `rank`, `world_size`, `device`,
    `backend` and the collectives (module docstring) over `group`."""

    def __init__(self, rank: int, world_size: int, device, backend: str,
                 group):
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.staged_bytes = 0

    # ---- staging -----------------------------------------------------
    def _in(self, t: torch.Tensor) -> torch.Tensor:
        """The operand as the backend reads it: a contiguous host copy of
        a CUDA tensor under gloo (counted), else the tensor itself."""
        if t.device != self.device:
            raise ValueError(f"operand on {t.device}, the mesh's rank "
                             f"{self.rank} runs on {self.device}")
        t = t.contiguous()
        if self.backend == "gloo" and t.is_cuda:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A result back on the mesh's device (counted when staged)."""
        if t.device != self.device:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(self.device)
        return t

    def _host_like(self, t: torch.Tensor) -> torch.Tensor:
        """An empty receive buffer for `t` where the backend writes."""
        if self.backend == "gloo" and t.is_cuda:
            return torch.empty(t.shape, dtype=t.dtype)
        return torch.empty_like(t)

    # ---- collectives -------------------------------------------------
    def all_gather(self, t: torch.Tensor, tiled: bool = False):
        """Every rank's `t` in rank order: stacked [n, ...], or with
        `tiled` concatenated along the first axis."""
        x = self._in(t)
        outs = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(outs, x, group=self.group)
        return self._out(torch.cat(outs) if tiled else torch.stack(outs))

    def _reduce(self, t: torch.Tensor, op):
        x = self._in(t)
        if x is t:
            x = x.clone()
        dist.all_reduce(x, op=op, group=self.group)
        return self._out(x)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's `t` (a new tensor)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of every rank's `t` (a new tensor)."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def ppermute(self, t: torch.Tensor, shift: int = 1, out=None):
        """The ring shift of jax.lax.ppermute with perm [(i, i + shift)]:
        send `t` to rank + shift, return what rank - shift sent (written
        into `out`, a tensor of t's shape and dtype, when given)."""
        n = self.world_size
        if out is None:
            out = torch.empty_like(t)
        if n == 1 or shift % n == 0:
            out.copy_(t)
            return out
        x = self._in(t)
        recv = self._host_like(t)
        ops = [dist.P2POp(dist.isend, x, (self.rank + shift) % n,
                          group=self.group),
               dist.P2POp(dist.irecv, recv, (self.rank - shift) % n,
                          group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if recv.device != out.device:
            self.staged_bytes += recv.numel() * recv.element_size()
        out.copy_(recv)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank (a new tensor; every rank passes
        a tensor of the same shape and dtype)."""
        x = self._in(t)
        if x is t:
            x = x.clone()
        dist.broadcast(x, src, group=self.group)
        return self._out(x)

    def gather_to(self, t: torch.Tensor, dst: int = 0):
        """On rank `dst` every rank's `t` in rank order (a list); None on
        the others. Point to point: each rank sends its tensor once."""
        if self.world_size == 1:
            return [t.clone()]
        x = self._in(t)
        if self.rank != dst:
            dist.send(x, dst, group=self.group)
            return None
        outs = []
        for r in range(self.world_size):
            if r == dst:
                outs.append(t.clone())
                continue
            buf = torch.empty_like(x)
            dist.recv(buf, r, group=self.group)
            outs.append(self._out(buf))
        return outs

    def barrier(self) -> None:
        """Every rank reaches this point (an all_reduce of one value)."""
        self.psum(torch.zeros(1, device=self.device))

def joined() -> Mesh | None:
    """The mesh this process joined last, or None."""
    return _CURRENT


def current() -> Mesh:
    """The mesh this process joined last; raises if none."""
    if _CURRENT is None:
        raise RuntimeError(
            "no mesh: join a world first (parallel.mesh.join, from_env or "
            "spawn) or pass mesh="
        )
    return _CURRENT


def rank_device(rank: int, device=None) -> torch.device:
    """Rank `rank`'s device: the CPU when `device` names it, the card it
    names when it names one (cuda:k), else cuda:(rank % card count)."""
    if device is not None:
        d = torch.device(device)
        if d.type != "cuda" or d.index is not None:
            return d
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (with the "
                           "gloo backend) to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_backend(backend: str, device: torch.device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend takes CUDA tensors; use gloo on "
                         f"{device}")


def join(backend: str, world_size: int, rank: int, init_method: str,
         device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Make this process rank `rank` of a world of `world_size` (module
    docstring) and return its mesh."""
    global _CURRENT
    dev = rank_device(rank, device)
    _check_backend(backend, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _CURRENT = Mesh(rank, world_size, dev, backend, dist.group.WORLD)
    # a first collective, so that a world the backend refuses fails here
    _CURRENT.barrier()
    return _CURRENT


def leave(mesh: Mesh) -> None:
    """Tear down the mesh's process group."""
    global _CURRENT
    if dist.is_initialized():
        dist.destroy_process_group()
    if _CURRENT is mesh:
        _CURRENT = None


def from_env(backend: str, device=None,
             timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the world `torchrun` describes (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT): rank r on cuda:LOCAL_RANK unless `device`
    names the CPU."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is None or torch.device(device).type == "cuda":
        device = rank_device(local, device)
    return join(backend, world, rank, "env://", device, timeout_s)


def in_torchrun() -> bool:
    """Whether this process was started by torchrun (RANK and WORLD_SIZE
    set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_main(rank, fn, world_size, backend, device, init_method, out_dir,
               timeout_s, args):
    mesh = join(backend, world_size, rank, init_method, device, timeout_s)
    if mesh.device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
    finally:
        leave(mesh)


def spawn(fn, world_size: int, backend: str, device=None, args=(),
          timeout_s: float = DEFAULT_TIMEOUT_S,
          run_timeout_s: float | None = None) -> list:
    """`fn(mesh, *args)` on every rank of a new world of `world_size`;
    returns the results in rank order (module docstring). `fn` must be a
    module-level function and `args` and the results picklable.
    `timeout_s` bounds each collective's wait; `run_timeout_s` (default
    4 x timeout_s) the whole run, after which every rank is ended and
    TimeoutError raised. An exception of any rank ends the others and is
    raised here."""
    import torch.multiprocessing as mp

    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if device is None or torch.device(device).type == "cuda":
        # build the kernels once, here, not in every rank at once
        from slam2d_tpu_torch.ops import _build

        rank_device(0, device)
        _build.load_library()
    with tempfile.TemporaryDirectory(prefix="slam2d_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        if world_size == 1:
            mesh = join(backend, 1, 0, init, device, timeout_s)
            try:
                return [fn(mesh, *args)]
            finally:
                leave(mesh)
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world_size, backend, device, init, tmp, timeout_s,
                  tuple(args)),
            nprocs=world_size, join=False, start_method="spawn",
        )
        limit = 4 * timeout_s if run_timeout_s is None else run_timeout_s
        deadline = time.monotonic() + limit
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks ran past {limit:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
        return [
            torch.load(os.path.join(tmp, f"result_{r}.pt"),
                       weights_only=False)
            for r in range(world_size)
        ]
