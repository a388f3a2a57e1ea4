"""Process groups for the mesh engine (the counterpart of
``repro/launch/mesh.py``'s ``make_replica_mesh``): one replica per rank of
a flat ``torch.distributed`` group.

* Rank r computes on ``cuda:(r % device_count)`` (or the CPU).
* The wire is NCCL when every rank has a card of its own, gloo when ranks
  share a card or run on the CPU.  NCCL refuses two ranks on one device;
  gloo takes host tensors, so beside CUDA compute each collective is
  staged through pinned host buffers (``ReplicaGroup.staged``).  The
  compute stays on the card either way.
* ``spawn_ranks`` starts the R rank processes of a command line and
  waits for them; a rank learns its place from ``RANK_ENV``.

Nothing here runs at import.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.core.param_avg import ReplicaGroup

RANK_ENV = "REPRO_TORCH_RANK"          # "<rank>,<world>,<init method>"
TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(rank: int, device: torch.device) -> torch.device:
    """The device rank ``rank`` computes on."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(world: int, device: torch.device) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else
    gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_from_env():
    """(rank, world, init method) of a spawned rank, or None."""
    spec = os.environ.get(RANK_ENV)
    if not spec:
        return None
    rank, world, init = spec.split(",", 2)
    return int(rank), int(world), init


def init_replica_group(rank: int, world: int, init_method: str,
                       device: torch.device) -> ReplicaGroup:
    """Join the default process group as ``rank`` of ``world`` and bind
    this process to its device."""
    backend = backend_for(world, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return ReplicaGroup(rank, world,
                        staged=backend == "gloo" and device.type == "cuda")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, argv: list, world: int) -> None:
    """Run ``python -m module argv`` as ``world`` ranks and wait for
    them.  Rank 0's output is this process's; the others' standard
    output is dropped (rank 0 alone logs).  When a rank fails the others
    are stopped and ``SystemExit`` carries its exit code."""
    import repro_torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = []
    try:
        for r in range(world):
            env[RANK_ENV] = f"{r},{world},{init}"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv], env=dict(env),
                stdout=None if r == 0 else subprocess.DEVNULL))
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                raise SystemExit(bad[0])
            if all(c == 0 for c in codes):
                return
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
