"""K1's share of its roofline in the traced slice: the sum of each
launch's least time (bytes its rows need at HBM bandwidth, or operations
at the bf16 peak) over the kernel's device time."""

from gpu_bench import readers


def read(rec):
    if not rec.get("trace"):
        return None
    return readers.share(readers.paged_bound_s(rec),
                         readers.kernel_s(rec, "paged_decode_attention"))
