"""Process start-up for multi-card training (counterpart of
mvs_tpu.parallel.distributed).

The launch contract is torchrun's, the one the reference's
torch.distributed.launch set (CasMVSNet/train.py:62-63,297-302): every
process reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (and
``LOCAL_WORLD_SIZE``), ``MASTER_ADDR`` and ``MASTER_PORT`` from its
environment, and ``maybe_initialize_distributed`` initialises
torch.distributed from them (``env://``). Without those variables it is a
no-op: a plain single process.

A rank's device is ``cuda:LOCAL_RANK`` unless the caller names one; the
CPU only when asked for. The backend follows from the devices:
  * NCCL where every rank has a card of its own;
  * gloo on the CPU;
  * gloo for ranks that share one card (a device named explicitly with
    more than one rank on the host): NCCL refuses two ranks on one device.
Gloo moves CUDA tensors for ``all_reduce`` and ``broadcast`` only, so the
port uses only those two collectives on tensors.

``launch_local`` starts such a process group on this host without torchrun
(one process per rank, each with the variables above), which is how the
tests and chip_smoke.py run ranks.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from mvs_tpu_torch.utils.platform import resolve_device

__all__ = ["ProcessInfo", "maybe_initialize_distributed", "barrier",
           "shutdown", "choose_backend", "launch_local", "free_port"]


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str | None  # None: a single process, torch.distributed unused


_info: ProcessInfo | None = None


def choose_backend(device: torch.device, named: bool,
                   local_world_size: int) -> str:
    """The backend rule: gloo on the CPU and for ranks that share one card
    (`named`: the caller named the device, so every rank on the host takes
    it), NCCL where each rank has a card of its own."""
    if device.type != "cuda":
        return "gloo"
    return "gloo" if named and local_world_size > 1 else "nccl"


def maybe_initialize_distributed(device=None) -> ProcessInfo:
    """Initialise torch.distributed from torchrun's variables, once.

    Returns this process's ProcessInfo; without RANK and WORLD_SIZE in the
    environment, a single process on resolve_device(device). Safe to call
    more than once (the first call's device stands). The first line a rank
    prints names its backend."""
    global _info
    if _info is not None:
        return _info
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return ProcessInfo(0, 1, 0, resolve_device(device), None)
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu "
                               "to run the ranks on the CPU")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own "
                f"({torch.cuda.device_count()} visible); name one with "
                f"--device cuda:0 to share it (backend gloo)")
        dev = torch.device(f"cuda:{local_rank}")
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda:0")
    backend = choose_backend(dev, device is not None, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"rank {rank}/{world}: torch.distributed backend {backend} on "
          f"{dev}", flush=True)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    _info = ProcessInfo(rank, world, local_rank, dev, backend)
    return _info


def barrier() -> None:
    """Wait for every rank; a no-op in a single process."""
    if _info is None:
        return
    if _info.backend == "nccl":
        dist.barrier(device_ids=[_info.device.index])
    else:
        dist.barrier()


def shutdown() -> None:
    """Destroy the process group that maybe_initialize_distributed made."""
    global _info
    if _info is not None:
        dist.destroy_process_group()
        _info = None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(argv: list[str], world_size: int, timeout: float,
                 env: dict | None = None, cwd=None) -> list[tuple[int, str]]:
    """Run `argv` as `world_size` ranks on this host, each with torchrun's
    variables (MASTER_ADDR 127.0.0.1, a free port). Returns each rank's
    (exit code, output); a rank still running after `timeout` seconds is
    killed (a negative exit code), and every rank is gone when this
    returns."""
    port = free_port()
    procs, logs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for rank in range(world_size):
                renv = dict(os.environ if env is None else env)
                renv.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                            LOCAL_RANK=str(rank),
                            LOCAL_WORLD_SIZE=str(world_size),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                log = open(Path(tmp) / f"rank{rank}.log", "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    argv, cwd=cwd, env=renv, stdout=log,
                    stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
            deadline = time.monotonic() + timeout
            for p in procs:
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = []
        for p, log in zip(procs, logs):
            log.seek(0)
            out.append((p.returncode, log.read()))
            log.close()
    return out
