"""K3's forward (prefill) share of its roofline in the traced slice."""

from gpu_bench import readers


def read(rec):
    if rec["kind"] != "serve" or not rec.get("trace"):
        return None
    return readers.share(readers.flash_fwd_bound_s(rec),
                         readers.kernel_s(rec, "flash_attention"))
