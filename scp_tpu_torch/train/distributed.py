"""Data-parallel bring-up of the port's trainer (the twin of
scp_tpu/train/distributed.py).

scp_tpu runs one process per host and lets `jax.distributed.initialize()`
join them into one runtime whose mesh spans every chip; its trainer then
takes one jitted step over the batch-sharded global array.  The port runs
one process per card (a rank), joined by `torch.distributed`: NCCL between
cards, gloo on the CPU (and for several ranks on one card, which NCCL
refuses).  A rank computes its rows of the global batch, and the step stays
scp_tpu's:

  * the loss is the mean over the global batch (the ranks' means
    averaged; every rank holds the same number of rows);
  * BatchNorm normalizes with the statistics of the global batch
    (`global_sum` on its moments, with their gradient where scp_tpu has it);
  * dropout masks are drawn for the global batch and each rank keeps its
    rows (models/octattention.py);
  * the gradients are averaged over the ranks after the backward
    (`average_gradients`), so Adam's replicated update leaves identical
    parameters on every rank.

Bring-up (`maybe_initialize`), from the environment:

  # torchrun: one process per card, every variable set by torchrun
  torchrun --nproc-per-node 4 -m scp_tpu_torch.cli.train --config-name ...

  # scp_tpu's recipe: one process index per host; the training CLI starts
  # one rank per local card under it (LOCAL_RANK / LOCAL_WORLD_SIZE)
  SCP_COORDINATOR=host0:8476 SCP_NUM_PROCESSES=2 SCP_PROCESS_ID=$i \\
      python -m scp_tpu_torch.cli.train --config-name ...

Without either, nothing is brought up and the rank is 0.  With one rank,
or none, every helper here is the identity and the single-device trainer
runs as it did.  `cfg.data.batch_size` stays the GLOBAL batch: each rank's
ShardDataset draws its process-strided slice of every global batch.

`run_workers` starts the ranks of one machine itself (spawned processes,
a rendezvous file, a timeout on every join); the training CLI, the tests,
tools/dryrun_multichip.py and chip_smoke.py start their ranks through it.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback

TORCHRUN_VARS = ("RANK", "WORLD_SIZE")
TIMEOUT_S = 1800.0  # a collective that waits longer fails its rank


def _dist():
    import torch.distributed as dist

    return dist


def world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_lead() -> bool:
    """The rank that writes run-dir files (scp_tpu's process 0)."""
    return rank() == 0


def local_rank(env=os.environ) -> int:
    return int(env.get("LOCAL_RANK", 0))


def backend_for(device, world: int = 1) -> str:
    """NCCL for ranks on cards, one rank per card; gloo on the CPU, and
    for more ranks than cards (NCCL refuses two ranks on one card)."""
    import torch

    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def maybe_initialize(env=os.environ, device=None) -> int:
    """Bring up torch.distributed when the environment asks for it;
    returns this process's rank (0 when nothing is configured).

    torchrun's RANK / WORLD_SIZE (with MASTER_ADDR / MASTER_PORT) take
    precedence; otherwise scp_tpu's SCP_COORDINATOR (host:port),
    SCP_NUM_PROCESSES (hosts) and SCP_PROCESS_ID (this host), where each
    host runs LOCAL_WORLD_SIZE ranks (1 by default) and this one is
    LOCAL_RANK of them.  The backend is NCCL for a CUDA `device` (the
    default) and gloo for the CPU."""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_rank()
    if all(v in env for v in TORCHRUN_VARS):
        r, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init = "env://"
    elif env.get("SCP_COORDINATOR"):
        local_world = int(env.get("LOCAL_WORLD_SIZE", 1))
        world = int(env["SCP_NUM_PROCESSES"]) * local_world
        r = int(env["SCP_PROCESS_ID"]) * local_world + local_rank(env)
        init = f"tcp://{env['SCP_COORDINATOR']}"
    else:
        return 0
    dist.init_process_group(backend_for("cuda" if device is None else device),
                            init_method=init, rank=r, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return r


def global_sum(t, grad: bool = False):
    """Sum of `t` over the ranks (the identity with one rank).  With
    `grad`, differentiable: the backward sums the cotangents of every rank
    (torch.distributed.nn.functional.all_reduce), which is what a statistic
    of the global batch needs."""
    if world_size() == 1:
        return t
    if grad:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t)
    out = t.clone()
    _dist().all_reduce(out)
    return out


def global_mean(t):
    """Mean of `t` over the ranks, without gradient."""
    n = world_size()
    return t if n == 1 else global_sum(t.detach()) / n


def average_gradients(params) -> None:
    """Average the gradients over the ranks in one all-reduce of a flat
    f32 bucket (a parameter without a gradient has none on every rank:
    the ranks run one program).  Nothing with one rank."""
    import torch

    n = world_size()
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    _dist().all_reduce(flat)
    flat /= n
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()


def barrier() -> None:
    if world_size() > 1:
        _dist().barrier()


# ---- starting the ranks of one machine ------------------------------------------


def _worker(index, fn, world, backend, workdir, threads, pg_timeout_s, rendezvous, args):
    """One spawned rank: environment, an intra-op thread pool of `threads`,
    the process group over the rendezvous file (unless fn brings it up
    itself), fn(*args), its result saved for the parent; the group torn
    down in any case."""
    import torch
    import torch.distributed as dist

    os.environ.update(LOCAL_RANK=str(index), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":  # one rank per card
        torch.cuda.set_device(index % torch.cuda.device_count())
    if rendezvous:
        os.environ.update(RANK=str(index), WORLD_SIZE=str(world))
        dist.init_process_group(backend,
                                init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                                rank=index, world_size=world,
                                timeout=datetime.timedelta(seconds=pg_timeout_s))
    try:
        result = fn(*args)
        torch.save(result, os.path.join(workdir, f"result-{index}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"error-{index}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_workers(fn, world: int, args=(), backend: str = "gloo", workdir: str | None = None,
                threads: int | None = 1, timeout_s: float | None = 600.0,
                rendezvous: bool = True) -> list:
    """Run fn(*args) as `world` ranks of one process group, in spawned
    processes; returns their results in rank order (each torch.save'd by
    its rank).  `fn` must be importable (a module-level function).

    A rank that raises, dies or outlives `timeout_s` (None: no deadline)
    fails the call: the others are killed and RuntimeError (TimeoutError
    past the deadline) names the rank and carries its traceback.  The
    rendezvous is a file in `workdir` (a new temporary directory by
    default), so concurrent runs never race for a port; with
    `rendezvous=False` each rank gets only LOCAL_RANK / LOCAL_WORLD_SIZE
    and fn brings the group up itself (maybe_initialize, scp_tpu's
    multi-host recipe).  A collective that waits longer than `timeout_s`
    (TIMEOUT_S without a deadline) fails its rank."""
    import torch
    import torch.multiprocessing as mp

    workdir = workdir or tempfile.mkdtemp(prefix="scp_dp_")
    os.makedirs(workdir, exist_ok=True)
    stale = [n for n in os.listdir(workdir) if n == "rendezvous" or n.startswith(("result-",
                                                                                    "error-"))]
    for n in stale:
        os.remove(os.path.join(workdir, n))
    pg_timeout_s = timeout_s or TIMEOUT_S
    ctx = mp.start_processes(_worker, args=(fn, world, backend, workdir, threads, pg_timeout_s,
                                            rendezvous, tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + (timeout_s or float("inf"))
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} still "
                                   f"running after {timeout_s:.0f} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        path = os.path.join(workdir, f"error-{e.error_index}.txt")
        detail = open(path).read() if os.path.exists(path) else str(e)
        raise RuntimeError(f"rank {e.error_index} of {world} failed:\n{detail}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [torch.load(os.path.join(workdir, f"result-{i}.pt"), weights_only=False)
            for i in range(world)]
