"""The engine's ``suspensions`` counter's growth over the window, per
second."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    c0, c1 = rec["counters"]
    return (c1["suspensions"] - c0["suspensions"]) / rec["seconds"]
