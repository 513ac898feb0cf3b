"""whole step: the model FLOPs of every rank's steps in the window over the window's
seconds x the cards x the bf16 peak (989 TFLOP/s), in percent."""


def read(rec):
    flops = sum(rec["step_counts"]) * rec["flops_per_step"]
    if flops <= 0:
        return None
    return 100.0 * flops / (rec["window_s"] * rec["chips"] * rec["peak_flops"])
