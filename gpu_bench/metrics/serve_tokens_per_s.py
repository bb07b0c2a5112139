"""Output tokens of every request produced inside the window, over the
window's seconds (a token's time is the end of the step that made it)."""

from gpu_bench import readers


def read(rec):
    if rec["kind"] != "serve":
        return None
    return readers.window_tokens(rec) / rec["seconds"]
