"""Several processes: the launch contract, the process group and the LOSO
folds split across processes (counterpart of
sie_tpu/parallel/multihost.py).

The launcher contract is the JAX package's:
  SIE_TPU_COORDINATOR   host:port of process 0 (a TCP store there)
  SIE_TPU_NUM_PROCESSES total process count
  SIE_TPU_PROCESS_ID    this process's id (0-based)
and one of the port's own, optional:
  SIE_TPU_BACKEND       'nccl' or 'gloo' (default nccl for a card, gloo
                        for the CPU). Processes that share one card use
                        gloo: NCCL refuses two ranks on one device.
A process given a bare 'cuda' device takes card (process id modulo the
host's card count).

`spawn_workers` is the self-launch of `python -m sie_tpu_torch.run
--mesh N` without those variables: one worker a local card (or the CPU
processes of `--device cpu`, or workers sharing the card of an explicit
`--device cuda:K`, over gloo), each with the variables set.

`run_loso_multihost` trains this process's contiguous slice of the
leave-one-subject-out folds (`host_fold_slice`); the folds need no
collective.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sie_tpu_torch.config import Config
from sie_tpu_torch.device import DeviceLike

def multihost_requested() -> bool:
    """True when the environment asks for several processes."""
    return bool(os.environ.get("SIE_TPU_COORDINATOR")) and int(
        os.environ.get("SIE_TPU_NUM_PROCESSES", "1") or 1) > 1


def process_device(device: DeviceLike = None) -> torch.device:
    """The device of this process: `device` as given, except that a bare
    'cuda' (or None) becomes card (process id modulo the card count)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        pid = int(os.environ.get("SIE_TPU_PROCESS_ID", "0") or 0)
        dev = torch.device("cuda", pid % torch.cuda.device_count())
    return dev


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: DeviceLike = None,
                     backend: Optional[str] = None) -> bool:
    """torch.distributed's process group for the launch. Arguments fall
    back to the environment (module docstring); a no-op returning False
    when neither asks for more than one process. Idempotent: True again
    once initialised. On a card, the card of this process becomes the
    current device."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("SIE_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SIE_TPU_NUM_PROCESSES", "1") or 1)
    if process_id is None:
        pid = os.environ.get("SIE_TPU_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator_address or (num_processes or 1) <= 1:
        return False
    if dist.is_initialized():
        return True
    if process_id is None:
        raise ValueError("SIE_TPU_PROCESS_ID is not set")
    dev = process_device(device)
    if backend is None:
        backend = os.environ.get("SIE_TPU_BACKEND") or (
            "nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(minutes=30), **kw)
    return True


def rank_and_world() -> Tuple[int, int]:
    """(this process's index, the process count); (0, 1) without a
    process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_fold_slice(n_folds: int, process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> slice:
    """Contiguous fold range for this process. The ranges over all
    processes are disjoint and exhaustive; processes with index <
    (n_folds % processes) take one extra fold."""
    rank, world = rank_and_world()
    process_index = rank if process_index is None else process_index
    process_count = world if process_count is None else process_count
    base, extra = divmod(n_folds, max(process_count, 1))
    start = process_index * base + min(process_index, extra)
    stop = start + base + (1 if process_index < extra else 0)
    return slice(start, stop)


def run_loso_multihost(cfg: Config, n_subjects: int, mesh=None,
                       synthetic: Optional[bool] = None,
                       verbose: bool = True,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None,
                       device: DeviceLike = None,
                       ) -> Tuple[List[dict], slice]:
    """Train and test this process's slice of the LOSO folds -> (its fold
    metrics, the slice). Call `init_distributed()` first in a
    multi-process launch. The folds run without a mesh: each process
    trains its own."""
    from sie_tpu_torch.parallel.loso import run_loso
    if mesh is not None:
        raise ValueError("LOSO folds split across processes take no mesh: "
                         "each process trains its folds alone")
    sl = host_fold_slice(n_subjects, process_index, process_count)
    results = run_loso(cfg, n_subjects=n_subjects, synthetic=synthetic,
                       verbose=verbose, fold_slice=sl,
                       device=process_device(device))
    return results, sl


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_mesh_devices(n: int, device: str) -> torch.device:
    """`device`, after the check `make_mesh` makes: a bare 'cuda' lays a
    mesh of n out over n local cards, and fewer raise ValueError; 'cpu',
    or an explicit 'cuda:K' that n processes share, takes any n."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(f"mesh needs {n} devices, have {have}")
    return dev


def spawn_workers(argv: Sequence[str], n: int, device: str,
                  module: str = "sie_tpu_torch.run") -> int:
    """Runs `python -m module *argv` as n worker processes with the launch
    variables set and waits for them -> the first nonzero exit code, else
    0. A bare 'cuda' device needs n local cards (ValueError otherwise,
    as make_mesh raises) and gives worker i card i over NCCL; 'cpu', or
    an explicit 'cuda:K' that every worker shares, runs over gloo. Worker
    0's output passes through; the others' standard output is dropped
    (their errors stay)."""
    dev = check_mesh_devices(n, device)
    env = {**os.environ, "SIE_TPU_COORDINATOR": f"localhost:{free_port()}",
           "SIE_TPU_NUM_PROCESSES": str(n)}
    if dev.type == "cuda" and dev.index is None:
        env["SIE_TPU_BACKEND"] = "nccl"
    else:
        env["SIE_TPU_BACKEND"] = "gloo"
    procs = []
    try:
        for i in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv],
                env={**env, "SIE_TPU_PROCESS_ID": str(i)},
                stdout=None if i == 0 else subprocess.DEVNULL))
        while True:   # a failed worker ends the others, which would wait
            codes = [p.poll() for p in procs]   # at a collective forever
            failed = [c for c in codes if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
