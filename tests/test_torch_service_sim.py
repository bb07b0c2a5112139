"""The port's Spark-fidelity simulator against the JAX package's.

Every scenario of ``tests/test_service_sim.py`` runs through both
``repro.core.spark_sim`` and ``repro_torch.core.spark_sim``: the FAIR
and MURS service runs, batch against service, the paper's stage and
task counts, and fixed draws of the liveness fuzz test's
``(n_jobs, heap_gb, rate, agg)``.  The simulator does no tensor
arithmetic (it is host Python over the scheduler, the pool and the
sampler, each a copy), so every field of every ``ServiceMetrics`` must
be EQUAL, not close.  The port's runs also keep the reference test's
claims.
"""

import dataclasses
import enum

import pytest

from repro.core import spark_sim as jsim
from repro.core import service as jservice
from repro.core import tasks as jtasks
from repro.core import usage_models as jusage
from repro.sched import MursConfig as JMursConfig

from repro_torch.core import spark_sim as tsim
from repro_torch.core import service as tservice
from repro_torch.core import tasks as ttasks
from repro_torch.core import usage_models as tusage
from repro_torch.core import MursConfig as TMursConfig

PKGS = {
    "jax": (jsim, jservice, jtasks, jusage, JMursConfig),
    "torch": (tsim, tservice, ttasks, tusage, TMursConfig),
}


def _plain(obj):
    """A dataclass as plain data, every field (nested ones included); an
    enum member as its value, since each package has its own enum class."""
    def norm(x):
        if isinstance(x, enum.Enum):
            return x.value
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [norm(v) for v in x]
        return x
    return norm(dataclasses.asdict(obj))


def _assert_equal(a, b):
    da, db = _plain(a), _plain(b)
    assert da.keys() == db.keys()
    for key in da:
        assert da[key] == db[key], key


def _mix(sim):
    return [sim.make_sort(), sim.make_wc(), sim.make_grep()]


@pytest.fixture(scope="module")
def runs():
    """The FAIR and MURS service runs of the reference test, per
    package."""
    out = {}
    for name, (sim, _, _, _, murs) in PKGS.items():
        out[name] = {
            "fair": sim.run_service(_mix(sim), heap_gb=6.0,
                                    oom_is_fatal=False),
            "murs": sim.run_service(_mix(sim), heap_gb=6.0, murs=murs(),
                                    oom_is_fatal=False),
        }
    return out


@pytest.mark.parametrize("policy", ["fair", "murs"])
def test_service_metrics_equal(runs, policy):
    _assert_equal(runs["jax"][policy], runs["torch"][policy])


def test_service_claims_hold_on_the_port(runs):
    fair, murs = runs["torch"]["fair"], runs["torch"]["murs"]
    for jm in list(fair.jobs.values()) + list(murs.jobs.values()):
        assert jm.finish_time > 0
    assert fair.minor_gcs + fair.full_gcs > 0 and fair.total_gc_time > 0
    assert murs.suspensions > 0
    assert murs.jobs["grep"].exec_time < fair.jobs["grep"].exec_time
    assert murs.jobs["grep"].gc_time <= fair.jobs["grep"].gc_time
    assert murs.jobs["wc"].gc_time <= fair.jobs["wc"].gc_time
    assert (sum(j.spills for j in murs.jobs.values())
            <= sum(j.spills for j in fair.jobs.values()))


def test_batch_vs_service_equal():
    """Fig 1's motivation: WC beside PR in service mode against WC alone."""
    got = {}
    for name, (sim, *_rest) in PKGS.items():
        got[name] = (
            sim.run_service([sim.make_pr(), sim.make_wc()], heap_gb=15.0,
                            oom_is_fatal=False),
            sim.run_batch([sim.make_wc()], heap_gb=15.0),
        )
    (js, jb), (ts, tb) = got["jax"], got["torch"]
    _assert_equal(js, ts)
    assert jb.keys() == tb.keys() == {"wc"}
    _assert_equal(jb["wc"], tb["wc"])
    assert ts.jobs["wc"].exec_time > tb["wc"].jobs["wc"].exec_time * 1.2


def test_batch_runs_equal():
    got = {name: sim.run_batch([sim.make_grep(), sim.make_wc()], heap_gb=8.0)
           for name, (sim, *_rest) in PKGS.items()}
    assert set(got["jax"]) == set(got["torch"]) == {"grep", "wc"}
    for jid in got["jax"]:
        _assert_equal(got["jax"][jid], got["torch"][jid])
        assert got["torch"][jid].jobs[jid].finish_time > 0


@pytest.mark.parametrize("make,kwargs,stages", [
    ("make_grep", {}, 1),
    ("make_wc", {}, 2),
    ("make_sort", {}, 3),
    ("make_pr", {"iterations": 5}, 6),
    ("make_pr", {}, None),
])
def test_workload_shapes_equal(make, kwargs, stages):
    """Stage counts, and every stage's task specs, field by field."""
    j = getattr(jsim, make)(**kwargs)
    t = getattr(tsim, make)(**kwargs)
    assert j.job_id == t.job_id
    assert len(j.stages) == len(t.stages)
    if stages is not None:
        assert len(t.stages) == stages
    for js, ts in zip(j.stages, t.stages):
        assert [_plain(x) for x in js] == [_plain(x) for x in ts]


def test_task_counts_match_paper():
    pr = sum(len(s) for s in tsim.make_pr().stages)
    assert 300 <= pr <= 400  # Table III: ~372 PR tasks per executor
    assert sum(len(s) for s in tsim.make_wc().stages) == 250


def _fuzz_run(pkg, n_jobs, heap_gb, rate, agg):
    _, service, tasks, usage, murs = PKGS[pkg]
    api = tasks.ApiProfile(
        "fuzz",
        usage.UsageModel.SUB_LINEAR if agg else usage.UsageModel.LINEAR,
        rate=rate, garbage_per_byte=1.5,
    )
    ex = service.ServiceExecutor(
        cores=8, heap_bytes=heap_gb * 1e9, murs=murs(), dt=0.1,
        max_time=4000.0, oom_is_fatal=False,
    )
    for j in range(n_jobs):
        ex.submit(service.JobSpec(f"job{j}", [tasks.make_stage_tasks(
            f"job{j}", 0, n_tasks=12, stage_input_bytes=1.5e9,
            phases=[tasks.Phase("read", api, 1.0)], skew=0.3,
        )]))
    return ex.run()


@pytest.mark.parametrize("n_jobs,heap_gb,rate,agg", [
    (1, 4.0, 0.2, False),
    (3, 4.0, 4.0, True),
    (2, 7.5, 1.3, False),
    (3, 12.0, 2.6, True),
    (2, 20.0, 4.0, False),
    (3, 5.2, 0.9, False),
])
def test_fuzz_draws_equal(n_jobs, heap_gb, rate, agg):
    j = _fuzz_run("jax", n_jobs, heap_gb, rate, agg)
    t = _fuzz_run("torch", n_jobs, heap_gb, rate, agg)
    _assert_equal(j, t)
    if not t.oom:
        for jm in t.jobs.values():
            assert jm.finish_time > 0
    assert t.peak_pool_used_fraction >= 0.0
