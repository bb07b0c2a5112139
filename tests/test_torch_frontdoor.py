"""The port's front door, traffic generators and priority policy against
the JAX package's.

* The same seed gives the same ``Arrival`` list from ``poisson_trace``,
  ``bursty_trace`` and ``diurnal_trace`` in both packages (both draw
  from ``random.Random(seed)``).
* ``TokenBucket`` refills lazily and caps at its burst, take for take as
  the reference's does.
* ``shed_order`` of FAIR, MURS and ``PriorityPolicy`` gives the
  reference's order on the same rows.
* A seeded ``poisson_trace`` overload goes through ``FrontDoor`` over
  JAX's and the port's smoke engines: the admitted, shed and
  rate-limited counts, every outcome row and the goodput are equal
  exactly (greedy token values never change a schedule).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import sched as jsched  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serve.kv_cache import kv_bytes_per_token  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

CFG = ARCHS["internlm2-1.8b"].smoke()
TCFG = TARCHS["internlm2-1.8b"].smoke()


def _tenants(serve):
    return (
        serve.TenantProfile("interactive", weight=3.0, prompt_tokens=(2, 6),
                            output_tokens=(2, 8)),
        serve.TenantProfile("batch", weight=1.0, prompt_tokens=(8, 16),
                            output_tokens=(16, 32)),
    )


def _sig(trace):
    return [
        (a.tick, a.request.request_id, a.request.tenant,
         tuple(a.request.prompt), a.request.max_new_tokens)
        for a in trace
    ]


# ------------------------------------------------------------------- traffic
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_same_seed_same_trace_in_both_packages(kind, seed):
    def trace(serve):
        t = _tenants(serve)
        if kind == "poisson":
            return serve.poisson_trace(t, rate_per_tick=0.7, n_requests=150,
                                       seed=seed)
        if kind == "bursty":
            return serve.bursty_trace(t, rate_per_tick=0.7, n_requests=150,
                                      seed=seed)
        return serve.diurnal_trace(t, base_rate_per_tick=0.7,
                                   n_requests=150, seed=seed)

    port = trace(tserve)
    assert len(port) == 150
    assert _sig(port) == _sig(trace(jserve))
    assert all(isinstance(a.request, tserve.Request) for a in port)


def test_trace_validation_matches():
    for serve in (jserve, tserve):
        with pytest.raises(ValueError):
            serve.poisson_trace((), rate_per_tick=1.0, n_requests=1)
        with pytest.raises(ValueError):
            serve.bursty_trace(_tenants(serve), rate_per_tick=1.0,
                               n_requests=1, burst_factor=0.5)


# -------------------------------------------------------------- token bucket
def test_token_bucket_arithmetic():
    b = tserve.TokenBucket(rate=0.5, burst=2.0)
    assert b.try_take(0.0) and b.try_take(0.0)
    assert not b.try_take(0.0)
    assert b.try_take(2.0)  # 2 ticks × 0.5 = one token
    assert not b.try_take(2.0)
    b.try_take(1000.0)  # a long gap caps at burst
    assert b.tokens == pytest.approx(1.0)
    third = tserve.TokenBucket(rate=1.0 / 3.0, burst=1.0)
    assert third.try_take(0.0)
    for t in (3.0, 6.0, 9.0):  # the epsilon covers 0.999…
        assert third.try_take(t) and not third.try_take(t)
    assert not tserve.TokenBucket(rate=10.0, burst=2.0).try_take(100.0, 3.0)
    with pytest.raises(ValueError):
        tserve.TokenBucket(rate=-1.0, burst=1.0)
    with pytest.raises(ValueError):
        tserve.TokenBucket(rate=1.0, burst=0.0)


@pytest.mark.parametrize("seed", range(3))
def test_token_bucket_takes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    rate, burst = float(rng.uniform(0.0, 2.0)), float(rng.uniform(0.5, 4.0))
    jb = jserve.TokenBucket(rate=rate, burst=burst)
    tb = tserve.TokenBucket(rate=rate, burst=burst)
    now = 0.0
    for _ in range(200):
        now += float(rng.choice([0.0, 0.5, 1.0, 3.0]))
        cost = float(rng.choice([0.5, 1.0, 2.0]))
        assert tb.try_take(now, cost) == jb.try_take(now, cost)
        assert tb.tokens == jb.tokens


# ---------------------------------------------------------------- shed order
def _stats(**rows):
    """rows: name=(rate, demand_bytes, arrival_seq)"""
    return {
        g: {"rate": r, "demand_bytes": d, "arrival_seq": float(s)}
        for g, (r, d, s) in rows.items()
    }


def _policies(sched):
    return {
        "base": sched.BasePolicy(),
        "fair": sched.FairPolicy(),
        "murs": sched.MursPolicy(sched.MursConfig()),
        "priority": sched.PriorityPolicy(
            sched.PriorityConfig(weights={"gold": 4.0, "low": 0.5})),
    }


@pytest.mark.parametrize("name", ["base", "fair", "murs", "priority"])
def test_shed_order_equals_reference(name):
    rows = [
        _stats(b=(9.0, 9e9, 1), a=(0.0, 0.0, 0), c=(5.0, 1e6, 2)),
        _stats(a=(1.0, 5e6, 0), b=(8.0, 1e6, 1), c=(3.0, 9e6, 2)),
        _stats(a=(0.0, 1e6, 0), b=(0.0, 8e6, 1), c=(0.0, 4e6, 2)),
        _stats(gold=(9.0, 9e9, 0), free=(0.0, 0.0, 1), low=(0.0, 0.0, 2)),
        _stats(y=(0.0, 0.0, 1), x=(0.0, 0.0, 0)),
    ]
    for stats in rows:
        groups = list(stats)
        assert (_policies(tsched)[name].shed_order(groups, stats)
                == _policies(jsched)[name].shed_order(groups, stats))


def test_shed_orders_by_policy():
    pols = _policies(tsched)
    fifo = _stats(b=(9.0, 9e9, 1), a=(0.0, 0.0, 0), c=(5.0, 1e6, 2))
    assert pols["fair"].shed_order(["b", "a", "c"], fifo) == ["a", "b", "c"]
    hot = _stats(a=(1.0, 5e6, 0), b=(8.0, 1e6, 1), c=(3.0, 9e6, 2))
    assert pols["murs"].shed_order(["a", "b", "c"], hot) == ["b", "c", "a"]
    cold = _stats(a=(0.0, 1e6, 0), b=(0.0, 8e6, 1), c=(0.0, 4e6, 2))
    assert pols["murs"].shed_order(["a", "b", "c"], cold) == ["b", "c", "a"]
    warm = tsched.MursPolicy(tsched.MursConfig())
    warm._group_rate = {"a": 9.0, "b": 1.0}  # the policy's EMA wins
    assert warm.shed_order(["a", "b"], _stats(a=(0.0, 0.0, 0),
                                              b=(99.0, 0.0, 1))) == ["a", "b"]
    weights = _stats(gold=(9.0, 9e9, 0), free=(0.0, 0.0, 1),
                     low=(0.0, 0.0, 2))
    assert pols["priority"].shed_order(["gold", "free", "low"], weights) == [
        "low", "free", "gold"]


# ------------------------------------------------- front door over engines
@pytest.fixture(scope="module")
def params():
    p = init_model(CFG, jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _door_run(port, params, policy_name):
    sched, serve = (tsched, tserve) if port else (jsched, jserve)
    policy = {
        "murs": lambda: sched.MursPolicy(
            sched.MursConfig.for_serving(period=1.0)),
        "priority": lambda: sched.PriorityPolicy(
            sched.PriorityConfig(weights={"interactive": 3.0})),
    }[policy_name]()
    kw = {"device": "cpu"} if port else {}
    eng = serve.ServingEngine(
        TCFG if port else CFG, params[1] if port else params[0],
        serve.EngineConfig(n_slots=2, max_seq=64,
                           hbm_capacity_bytes=kv_bytes_per_token(CFG) * 96,
                           policy=policy, **kw),
    )
    door = serve.FrontDoor(eng, serve.FrontDoorConfig(
        pressure_threshold=0.6, buckets={"batch": (0.1, 2.0)},
        default_slo=serve.SloSpec(latency_ticks=60)))
    trace = serve.poisson_trace(_tenants(serve), rate_per_tick=0.8,
                                n_requests=30, seed=13)
    return serve.drive(door, trace, max_ticks=400), eng


def _rows(report):
    return sorted(
        (o.request_id, o.tenant, o.outcome, o.submit_tick, o.finish_tick,
         o.first_token_tick, o.tokens, o.reason)
        for o in report.outcomes
    )


@pytest.mark.parametrize("policy_name", ["murs", "priority"])
def test_frontdoor_overload_equals_reference(params, policy_name):
    jrep, jeng = _door_run(False, params, policy_name)
    trep, teng = _door_run(True, params, policy_name)
    for key in ("admitted", "shed", "rate_limited", "shed_by_tenant"):
        assert trep.extras[key] == jrep.extras[key], key
    assert trep.extras["shed"] >= 1 and trep.extras["rate_limited"] >= 1
    assert (trep.extras["admitted"] + trep.extras["shed"]
            + trep.extras["rate_limited"]) == trep.submitted == 30
    assert _rows(trep) == _rows(jrep)
    assert trep.completed == jrep.completed == trep.extras["admitted"]
    assert trep.goodput == jrep.goodput
    assert teng.tick == jeng.tick
