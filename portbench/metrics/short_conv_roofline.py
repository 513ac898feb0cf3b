"""kernel (ops/short_conv.py -> csrc/short_conv.cu ts_short_conv_fwd and
ts_short_conv_bwd, an LFM2 conv layer's gated short convolution): the calls'
bound (the bytes a forward and a backward must move, 11 d bf16 a token, over
3.35 TB/s; archs/lfm2.py short_conv_bound_s) over the profiler's device time of
the forward, backward and tap-gradient reduction kernels, in percent, mean over
ranks; calls counted by forward launches."""

from harness.record import roofline_pct


def read(rec):
    return roofline_pct(rec, "short_conv")
