"""Device milliseconds per lockstep leaf in NCCL's kernels on rank 0:
the cells group's ``all_reduce`` of each leaf's likelihood and gradient,
and the chain group's gathers that end the block, from
``torch.profiler``'s device timeline of the profiled block, over the
program's ``nuts.leaf`` spans there.  A collective's kernel runs from
when this rank enters it until every rank of its group has, so the time
includes waiting for the slower rank.  None without NCCL's kernels in
the trace (one device, or the CPU)."""

from benchmark.program_record import milliseconds, per


def read(record):
    profile = record.get("profile")
    if not profile:
        return None
    seconds = sum(t for name, (t, _) in profile["ops"].items() if "nccl" in name.lower())
    return per(record, "nuts.leaf", lambda p: milliseconds(seconds)) if seconds else None
