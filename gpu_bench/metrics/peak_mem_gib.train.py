"""``torch.cuda.max_memory_allocated`` over the window (reset at its
opening), in GiB."""


def read(rec):
    if rec["kind"] != "train" or not rec["peak_window_bytes"]:
        return None
    return rec["peak_window_bytes"] / 2**30
