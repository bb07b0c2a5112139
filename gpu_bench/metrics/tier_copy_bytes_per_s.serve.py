"""Bytes the engine copied between device and host for its tiers over
the window (the growth of its ``tier_d2h_bytes`` and ``tier_h2d_bytes``
counters), per second, in MB/s."""

KEYS = ("tier_d2h_bytes", "tier_h2d_bytes")


def read(rec):
    if rec["kind"] != "serve":
        return None
    c0, c1 = rec["counters"]
    if not all(k in c0 for k in KEYS):
        return None
    return sum(c1[k] - c0[k] for k in KEYS) / rec["seconds"] / 1e6
