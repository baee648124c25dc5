"""Multi-process bring-up over ``torch.distributed`` (reference:
mxnet_tpu/distributed.py).

The environment protocol is the reference's, set by ``tools/launch.py``:
``MXTPU_COORDINATOR`` (host:port of rank 0), ``MXTPU_NUM_PROCESSES`` and
``MXTPU_PROCESS_ID``, or the ``DMLC_PS_ROOT_URI``/``DMLC_NUM_WORKER`` names.
:func:`init` joins one process group at ``tcp://<coordinator>``: NCCL when
the worker's context is a card, gloo when the caller asks for the CPU
(``ctx=mx.cpu()``, or the current context is the CPU). NCCL never falls back
to gloo. Every wait has an explicit timeout (``timeout=`` seconds, else
``MXNET_STALL_TIMEOUT_S``, else 300), so a peer that never arrives fails with
the process group's named error instead of hanging. With no coordinator in
the environment, :func:`init` is a one-process no-op: rank 0 of 1.

Failure detection (reference: ``get_num_dead_node``, after ps-lite's
heartbeats): with more than one process, a daemon thread stamps
``mxtpu/health/<rank>`` in the process group's store with a rising sequence
number; :func:`get_num_dead_node` counts the peers whose stamp has not moved
for ``timeout`` seconds on this process's clock.

Elastic recovery: ``tools/launch.py --max-restarts N`` relaunches the whole
job with ``MXTPU_RESTART_COUNT`` set; a worker reads :func:`is_recovery`
and resumes from its last checkpoint.
"""
from __future__ import annotations

import atexit
import datetime
import logging
import os
import threading
import time

__all__ = ["init", "is_initialized", "rank", "size", "barrier", "shutdown",
           "get_num_dead_node", "is_recovery", "restart_count", "backend"]

_DEFAULT_TIMEOUT_S = 300.0
_HEARTBEAT_PERIOD = float(os.environ.get("MXTPU_HEARTBEAT_PERIOD", "2.0"))

_STATE = {"initialized": False, "heartbeat": None, "stop": None}
# per-peer liveness log: {rank: (last stamp, local time it was first seen)}
_OBSERVED: dict = {}


def restart_count() -> int:
    """How many times the launcher has relaunched this job (0 on the first
    run); set by ``tools/launch.py --max-restarts``."""
    return int(os.environ.get("MXTPU_RESTART_COUNT", "0"))


def is_recovery() -> bool:
    """True when this process is a relaunch after a failure: resume from the
    last checkpoint instead of initialising afresh."""
    return restart_count() > 0


def _group_active() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _timeout_s(timeout):
    if timeout is not None:
        return float(timeout)
    env = os.environ.get("MXNET_STALL_TIMEOUT_S")
    return float(env) if env else _DEFAULT_TIMEOUT_S


def init(coordinator=None, num_processes=None, process_id=None, ctx=None,
         timeout=None):
    """Join the job's process group (reference: ``distributed.init``).
    ``ctx`` is the worker's context (default: the current one): a card
    means NCCL, the CPU gloo. Once joined, a second call does nothing; a
    call with no coordinator (a one-process run) joins nothing, and a later
    call that names one still joins."""
    coordinator = coordinator or os.environ.get("MXTPU_COORDINATOR") \
        or os.environ.get("DMLC_PS_ROOT_URI")
    num_processes = num_processes or os.environ.get("MXTPU_NUM_PROCESSES") \
        or os.environ.get("DMLC_NUM_WORKER")
    process_id = process_id if process_id is not None \
        else os.environ.get("MXTPU_PROCESS_ID")
    if coordinator is None or num_processes is None or _group_active():
        # a one-process run has nothing to join
        _STATE["initialized"] = True
        return
    import torch
    import torch.distributed as dist

    from .context import current_context

    if ctx is None:
        ctx = current_context()
    world, rank_ = int(num_processes), int(process_id or 0)
    if ctx.device_type == "gpu":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            from .base import MXNetError

            raise MXNetError(
                f"distributed.init: context {ctx} needs NCCL and a CUDA "
                "device; pass ctx=mx.cpu() to join over gloo")
        torch.cuda.set_device(ctx.torch_device)
        name = "nccl"
    else:
        name = "gloo"
    dist.init_process_group(
        name, init_method=f"tcp://{coordinator}", world_size=world,
        rank=rank_, timeout=datetime.timedelta(seconds=_timeout_s(timeout)))
    _STATE["initialized"] = True
    # leave the group before the interpreter tears down (NCCL warns of a
    # leak otherwise); a shutdown() before exit makes this a no-op
    atexit.register(shutdown)
    if world > 1:
        stop = threading.Event()
        t = threading.Thread(target=_heartbeat_loop, args=(stop, rank_),
                             name="mxtpu-heartbeat", daemon=True)
        t.start()
        _STATE["heartbeat"], _STATE["stop"] = t, stop


def _heartbeat_loop(stop, rank_):
    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    failures = 0
    seq = 0
    while True:
        try:
            seq += 1
            store.set(f"mxtpu/health/{rank_}", str(seq))
            failures = 0
        except (RuntimeError, OSError) as e:
            # a frozen stamp makes every peer count this worker dead: log
            # once, back off and keep trying
            failures += 1
            if failures == 5:
                logging.warning("mxtpu heartbeat: the process group's store "
                                "is unreachable (%s); retrying", e)
        if stop.wait(_HEARTBEAT_PERIOD * min(8, max(1, failures))):
            return


def get_num_dead_node(timeout: float = 15.0) -> int:
    """The peers whose heartbeat has not moved for ``timeout`` seconds, as
    this process's clock sees it; a peer that has not stamped yet gets
    ``timeout`` seconds from the first poll. 0 in a one-process run."""
    if not _group_active() or size() == 1:
        return 0
    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    now = time.time()
    dead = 0
    for p in range(size()):
        key = f"mxtpu/health/{p}"
        try:
            stamp = store.get(key) if store.check([key]) else None
        except (RuntimeError, OSError):
            stamp = None
        prev = _OBSERVED.get(p)
        if prev is None or prev[0] != stamp:
            _OBSERVED[p] = (stamp, now)
        elif now - prev[1] > timeout:
            dead += 1
    return dead


def is_initialized() -> bool:
    return _STATE["initialized"]


def backend():
    """The process group's backend (``"nccl"`` or ``"gloo"``), None without
    one."""
    if not _group_active():
        return None
    import torch.distributed as dist

    return dist.get_backend()


def rank() -> int:
    if not _group_active():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def size() -> int:
    if not _group_active():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def barrier(name: str | None = None):
    """A sync point of every worker (reference: ``KVStore::Barrier``);
    nothing in a one-process run. ``name`` is for the reader only."""
    if not _group_active() or size() == 1:
        return
    import torch.distributed as dist

    dist.barrier()


def _stop_heartbeat():
    if _STATE["stop"] is not None:
        _STATE["stop"].set()
        _STATE["heartbeat"].join(timeout=5)
        _STATE["heartbeat"], _STATE["stop"] = None, None


def shutdown():
    """Leave the process group (``destroy_process_group``); a later
    :func:`init` may join another."""
    _stop_heartbeat()
    if _group_active():
        import torch.distributed as dist

        dist.destroy_process_group()
    _OBSERVED.clear()
    _STATE["initialized"] = False
