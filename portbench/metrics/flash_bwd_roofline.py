"""kernel (ops/flash_attention.py flash_bwd -> csrc/flash_attention.cu ts_flash_bwd,
the causal attention backward): the calls' bound (the larger of bytes / 3.35 TB/s
and the model's FLOPs / 989 TFLOP/s, harness/arith.py flash_bwd_bound_s) over the
profiler's device time of its stats, dK/dV and dQ kernels, in percent, mean over
ranks; calls counted by dK/dV launches."""

from harness.record import roofline_pct


def read(rec):
    return roofline_pct(rec, "flash_bwd")
