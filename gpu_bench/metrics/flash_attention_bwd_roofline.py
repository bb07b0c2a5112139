"""K3's backward share of its roofline in the traced step: its launches'
least time (``flash_bwd_work`` at the shapes of the forward calls that
recorded a gradient) over its kernels' device time."""

from gpu_bench import readers


def read(rec):
    if rec["kind"] != "train" or not rec.get("trace"):
        return None
    return readers.share(readers.flash_bwd_bound_s(rec),
                         readers.kernel_s(rec, "flash_attention_bwd"))
