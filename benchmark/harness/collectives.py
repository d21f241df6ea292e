"""The mesh's all-to-alls in a traced stretch: NCCL runs each
dist.all_to_all_single (parallel/mesh.py's Mesh.all_to_all, the pencil
transposes) as one grouped send/receive kernel, ncclDevKernel_SendRecv
(ncclKernel_SendRecv_* before NCCL 2.19).  Its device time holds the wait
for the slowest peer as well as the transfer."""
from __future__ import annotations


def is_alltoall(name: str) -> bool:
    low = name.lower()
    return "nccl" in low and "sendrecv" in low


def alltoall(trace):
    """(seconds, calls) of the all-to-all kernels of a devtrace summary,
    or None where it holds none (one card, the CPU)."""
    if not trace or not trace.get("ops") or trace.get("steps", 0) <= 0:
        return None
    hits = [v for n, v in trace["ops"].items() if is_alltoall(n)]
    if not hits:
        return None
    return sum(s for s, _ in hits), sum(c for _, c in hits)
