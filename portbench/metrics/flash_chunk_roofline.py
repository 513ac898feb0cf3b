"""kernel (ops/flash_attention.py -> csrc/flash_attention.cu ts_flash_chunk): the
calls' bound (the larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s, from the
call's shapes) over the profiler's device time of the kernel, in percent, mean
over ranks."""

from harness.record import mean, traces


def read(rec):
    shares = [
        100.0 * t["flash_chunk_calls"] * rec["flash_chunk_bound_s"] / t["flash_chunk_s"]
        for t in traces(rec) if t["flash_chunk_calls"] and t["flash_chunk_s"] > 0
    ]
    return mean(shares) if shares else None
