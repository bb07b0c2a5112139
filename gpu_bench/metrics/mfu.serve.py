"""Model FLOPs of the prefill and decode tokens the traced slice
processed (from the attention calls' shapes and the configuration), over
the slice's seconds, as a share of one H100's 989 TFLOP/s (bf16, dense)."""

from gpu_bench import readers, work


def read(rec):
    if rec["kind"] != "serve" or not rec["trace"]:
        return None
    flops = readers.serve_slice_flops(rec)
    if flops <= 0:
        return None
    return 100.0 * flops / rec["trace"]["window_s"] / work.PEAK_BF16_FLOPS
