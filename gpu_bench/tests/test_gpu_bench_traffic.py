"""The traffic generator is a function of the mix and the seed alone, and
every seed serves the same multiset of sizes and gaps."""

import json
import math

from conftest import REPO

from gpu_bench import traffic


def mix(name="murs-two-group", **kw):
    m = json.loads((REPO / "gpu_bench" / "traffic" / f"{name}.json")
                   .read_text())
    m.update(kw)
    return m


def test_same_seed_same_requests():
    a = traffic.plan(mix(requests=300), 2**31 + 99, 92544)
    b = traffic.plan(mix(requests=300), 2**31 + 99, 92544)
    assert [(p.due, p.tenant, p.prompt, p.max_new_tokens) for p in a] == \
        [(p.due, p.tenant, p.prompt, p.max_new_tokens) for p in b]


def test_other_seed_same_sizes_other_order():
    a = traffic.plan(mix(requests=300), 1, 92544)
    b = traffic.plan(mix(requests=300), 2, 92544)
    size = lambda p: (p.group, len(p.prompt), p.max_new_tokens)  # noqa: E731
    assert sorted(map(size, a)) == sorted(map(size, b))
    assert list(map(size, a)) != list(map(size, b))
    gaps = lambda ps: sorted(round(y.due - x.due, 9)  # noqa: E731
                             for x, y in zip(ps, ps[1:]))
    assert math.isclose(a[-1].due, b[-1].due, rel_tol=0.05)
    assert len(gaps(a)) == len(gaps(b))


def test_lengths_and_shares_follow_the_mix():
    ps = traffic.plan(mix(requests=3000), 7, 92544)
    reason = [p for p in ps if p.group == "reason"]
    assert abs(len(reason) / len(ps) - 1 / 3) < 0.01
    assert all(256 <= len(p.prompt) <= 1024 and 256 <= p.max_new_tokens
               <= 1536 for p in reason)
    rate = len(ps) / ps[-1].due
    assert abs(rate / mix()["rate_per_s"] - 1) < 0.05


def test_shared_system_prompt_goes_to_one_tenant_of_three():
    m = mix("chat", requests=600)
    m["groups"][0]["shared_prefix"] = {"tokens": 512, "tenants": 1,
                                       "min_suffix": 16}
    ps = traffic.plan(m, 5, 92544)
    shared = [p for p in ps if p.shared]
    assert shared and {p.tenant for p in shared} == {"chat-0"}
    assert len({tuple(p.prompt[:512]) for p in shared}) == 1
    assert {p.tenant for p in ps} == {"chat-0", "chat-1", "chat-2"}


def test_bursts_keep_the_mean_rate():
    m = mix(requests=4000, bursts={"period_s": 10, "on_s": 2, "factor": 3})
    ps = traffic.plan(m, 3, 92544)
    assert abs(len(ps) / ps[-1].due / m["rate_per_s"] - 1) < 0.05
    on = sum(1 for p in ps if p.due % 10 < 2)
    assert abs(on / len(ps) - 0.6) < 0.05


def test_seeds_reorder_only_within_blocks():
    m = mix(requests=400)
    a = traffic.plan(m, 11, 92544)
    b = traffic.plan(m, 12, 92544)
    blk = m["shuffle_block"]
    for i in range(0, 400, blk):
        sa = sorted((p.group, len(p.prompt), p.max_new_tokens)
                    for p in a[i:i + blk])
        sb = sorted((p.group, len(p.prompt), p.max_new_tokens)
                    for p in b[i:i + blk])
        assert sa == sb
        assert math.isclose(a[i + blk - 1].due, b[i + blk - 1].due,
                            rel_tol=1e-9)
