"""Device rule and host-sync accounting for the port's entry points.

Entry points take an explicit ``device``. Left at ``None`` it means the
first CUDA device, and a host without one raises: the port never carries
on on the CPU by itself. ``device="cpu"`` is the caller's explicit choice
(the tests make it); there every kernel wrapper runs its plain PyTorch
version.

The solve's convergence gates are Python control flow on 0-d device
tensors, and each decision is a host sync (the stream drains before the
value reaches Python). ``item`` and ``finish_readback`` are the only ways
the solve path moves a value to the host, and ``host_syncs`` counts them
so a run can report syncs per solve. The count is kept under a lock: the
shards of a sharded solve (``parallel/sharded_solver.py``) run in threads
of their own and each reads every gate on its own device, so a sharded
solve counts one sync per gate read per shard (a mesh of 8 shards, 8 for
each gate), plus the one readback.

A readback is split in two: ``start_readback`` enqueues the copy behind
the work already on the tensor's stream and returns at once, and
``finish_readback`` waits for that copy alone. Work enqueued between the
two (the next solve) is not waited for.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch

# Host syncs made through item()/readback() since the process started (or
# the caller last zeroed it).
host_syncs = 0  #: guarded-by: _sync_lock
_sync_lock = threading.Lock()


def _count_sync() -> None:
    global host_syncs
    with _sync_lock:
        host_syncs += 1


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda:0``, or ``RuntimeError`` when no CUDA device
    exists; anything else is taken as the caller's choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the plain "
                "PyTorch path on the host"
            )
        return torch.device("cuda", 0)
    return torch.device(device)


def check_cublas_import_order(device) -> None:
    """Refuse a CUDA ``device`` in a process whose CUDA was up before the
    port was imported while ``CUBLAS_WORKSPACE_CONFIG`` was not ":0:0":
    PyTorch reads the variable at the first cuBLAS call, which may have
    come before the port set it, and cuBLAS's split-K then makes batched
    and fused answers differ from solo ones past the batch-parity gate
    (see ``modelmesh_tpu_torch/__init__.py``)."""
    import modelmesh_tpu_torch as pkg

    if torch.device(device).type != "cuda":
        return
    if pkg.CUDA_UP_AT_IMPORT and not pkg.CUBLAS_SET_AT_IMPORT:
        raise RuntimeError(
            "CUDA was initialized before modelmesh_tpu_torch was imported, "
            "so its CUBLAS_WORKSPACE_CONFIG=:0:0 may have come after the "
            "process's first cuBLAS call (split-K breaks batch parity); "
            "import modelmesh_tpu_torch first, or set "
            "CUBLAS_WORKSPACE_CONFIG=:0:0 before the first CUDA call"
        )


def resolve_kernel_impl(knob: str, value: str, device) -> str:
    """Validate a kernel-backend knob (``sparse_impl``, ``lse_impl``) and
    name the backend that runs: "cuda" for CUDA tensors, "plain" (the
    kernels' PyTorch versions) for CPU tensors. An explicit "cuda" on CPU
    tensors raises instead of running plain."""
    if value not in ("auto", "cuda"):
        raise ValueError(f"{knob}={value!r} (expected auto | cuda)")
    if torch.device(device).type == "cuda":
        return "cuda"
    if value == "cuda":
        raise ValueError(f"{knob}='cuda' needs the problem on a CUDA device")
    return "plain"


def item(t: torch.Tensor):
    """``t.item()``, counted as one host sync."""
    _count_sync()
    return t.item()


class Readback(NamedTuple):
    """A copy to host memory in flight: ``host`` holds the bytes once
    ``done`` (recorded after the copy) has completed; ``done`` is None
    when the source was already on the host."""

    host: torch.Tensor
    done: Optional[torch.cuda.Event]


def start_readback(t: torch.Tensor) -> Readback:
    """Enqueue ``t``'s copy to host memory without waiting: a pinned
    buffer, a non-blocking copy on the current stream of ``t``'s device
    and an event recorded after it. A CPU tensor is its own copy."""
    if t.device.type != "cuda":
        return Readback(t, None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return Readback(host, done)


def finish_readback(rb: Readback) -> torch.Tensor:
    """Wait for ``rb``'s copy (and only for the work enqueued before it),
    counted as one host sync; the host tensor."""
    _count_sync()
    if rb.done is not None:
        rb.done.synchronize()
    return rb.host
