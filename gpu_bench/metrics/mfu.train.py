"""Model FLOPs of a step (6 x the weights each token touches and causal
attention's products, remat's recompute not counted) over the window's
seconds per step, leaving out the step the profiler traced, as a share
of one H100's 989 TFLOP/s (bf16, dense)."""

from gpu_bench import work


def read(rec):
    steps = rec["kind"] == "train" and rec["untraced_step_s"]
    if not steps:
        return None
    flops = work.train_step_flops(rec["model"], rec["batch"], rec["seq"])
    return 100.0 * flops * len(steps) / sum(steps) / work.PEAK_BF16_FLOPS
