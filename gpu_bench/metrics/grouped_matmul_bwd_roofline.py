"""K5's backward share of its roofline in the traced step
(``gmm_bwd_work``'s pair at each expert product's shapes)."""

from gpu_bench import readers


def read(rec):
    if rec["kind"] != "train" or not rec.get("trace"):
        return None
    return readers.share(readers.gmm_bwd_bound_s(rec),
                         readers.kernel_s(rec, "grouped_matmul_bwd"))
