"""Mean output tokens per step that ran a paged decode (the engine's
``paged_decode_ticks`` moved), inside the window."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    n = [new for _, _, new, paged in rec["steps"] if paged]
    return sum(n) / len(n) if n else None
