"""Paper-fidelity workloads and experiment harness (paper §VI).

Reproduces the evaluation setup of MURS §VI on the discrete-event executor:

  * cluster: 4 workers × (2 × 8-core Xeon-2670), 64 GB; we simulate one
    executor JVM on its 1/4 input share (workers are homogeneous and jobs are
    embarrassingly parallel across executors, so ratios are preserved);
  * applications (Table II):
      Grep  — 1 stage,  ``filter``                        (constant), no cache
      WC    — 2 stages, ``flatMap & reduceByKey``         (sub-linear write)
      Sort  — 3 stages, ``distinct & sortByKey``          (linear read)
      PR    — N stages, ``groupByKey & map & reduceByKey``(linear) + caching
  * datasets: WC 50 GB / Sort 30 GB (HiBench RandomWriter, 1B unique keys);
    Grep / PR webbase-2001 30 GB;
  * task counts match Table III: WC 1000, PR 1500 (per 5-iteration run).

All byte figures below are per-executor (i.e. dataset/4).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional

from ..sched import MursConfig
from .service import GcModel, JobSpec, ServiceExecutor, ServiceMetrics
from .tasks import ApiProfile, Phase, make_stage_tasks  # noqa: F401
from .usage_models import UsageModel

__all__ = [
    "GB",
    "APIS",
    "make_grep",
    "make_wc",
    "make_sort",
    "make_pr",
    "run_service",
    "run_batch",
]

GB = 1e9

# ---------------------------------------------------------------- API table
# Rates are buffer-to-input ratios at phase completion (see tasks._slope) and
# include the managed-runtime object-bloat factor (~3× raw bytes — the paper
# motivates exactly this bloat via [3]); garbage_per_byte models the
# young-generation churn of each operator.
APIS: Dict[str, ApiProfile] = {
    # constant: streams records through; tiny fixed working set
    "filter": ApiProfile("filter", UsageModel.CONSTANT, rate=8e6, garbage_per_byte=1.2),
    "map": ApiProfile("map", UsageModel.CONSTANT, rate=8e6, garbage_per_byte=1.5),
    # flatMap produces massive temporaries (paper §VI-B: WC's heap is
    # occupied by flatMap garbage during the write phase)
    "flatMap": ApiProfile("flatMap", UsageModel.CONSTANT, rate=16e6, garbage_per_byte=4.0),
    # sub-linear: aggregating shuffle (reduceByKey); 1B unique keys on the
    # HiBench datasets → substantial but sub-linear aggregation buffer
    "reduceByKey": ApiProfile(
        "reduceByKey", UsageModel.SUB_LINEAR, rate=0.9, garbage_per_byte=2.0
    ),
    "combine": ApiProfile(
        "combine", UsageModel.SUB_LINEAR, rate=0.6, garbage_per_byte=1.5
    ),
    # linear: non-aggregating shuffles hold the whole (bloated) partition
    "sortByKey": ApiProfile(
        "sortByKey", UsageModel.LINEAR, rate=3.0, garbage_per_byte=2.5
    ),
    "distinct": ApiProfile(
        "distinct", UsageModel.LINEAR, rate=2.0, garbage_per_byte=2.0
    ),
    "groupByKey": ApiProfile(
        "groupByKey", UsageModel.LINEAR, rate=3.0, garbage_per_byte=3.0
    ),
}


# ------------------------------------------------------------- applications
def make_grep(job_id: str = "grep", *, input_gb: float = 30.0, submit: float = 0.0) -> JobSpec:
    share = input_gb * GB / 4.0
    tasks = make_stage_tasks(
        job_id,
        0,
        n_tasks=60,
        stage_input_bytes=share,
        phases=[Phase("process", APIS["filter"], 1.0)],
    )
    return JobSpec(job_id, [tasks], submit_time=submit)


def make_wc(job_id: str = "wc", *, input_gb: float = 50.0, submit: float = 0.0) -> JobSpec:
    share = input_gb * GB / 4.0
    # Paper Table III: WC = 1000 tasks total → 125/stage/executor.
    # Stage 0 (map side): flatMap then the reduceByKey map-side combine in
    # the task *write* phase — the paper notes WC's pressure appears in the
    # write phase of the first stage amid flatMap temporaries.
    s0 = make_stage_tasks(
        job_id,
        0,
        n_tasks=125,
        stage_input_bytes=share,
        phases=[
            Phase("process", APIS["flatMap"], 0.5),
            Phase("write", APIS["reduceByKey"], 0.5),
        ],
        skew=0.5,
        # hot keys gather (§III redefinition): aggregation degenerates to
        # linear in ~10% of partitions — the source of WC's rare 710 MB spill
        hot_fraction=0.10,
        hot_api=APIS["groupByKey"],
    )
    # Stage 1 (reduce side): aggregated data is much smaller
    s1 = make_stage_tasks(
        job_id,
        1,
        n_tasks=125,
        stage_input_bytes=share * 0.3,
        phases=[
            Phase("read", APIS["combine"], 0.6),
            Phase("process", APIS["map"], 0.4),
        ],
        skew=0.5,
    )
    return JobSpec(job_id, [s0, s1], submit_time=submit)


def make_sort(job_id: str = "sort", *, input_gb: float = 30.0, submit: float = 0.0) -> JobSpec:
    share = input_gb * GB / 4.0
    s0 = make_stage_tasks(
        job_id, 0, n_tasks=60, stage_input_bytes=share,
        phases=[
            Phase("process", APIS["map"], 0.4),
            Phase("write", APIS["distinct"], 0.6),
        ],
        skew=0.3,
    )
    s1 = make_stage_tasks(
        job_id, 1, n_tasks=60, stage_input_bytes=share * 0.9,
        phases=[
            Phase("read", APIS["distinct"], 0.5),
            Phase("write", APIS["sortByKey"], 0.5),
        ],
        skew=0.3,
    )
    # Final sort stage: the linear read-phase buffer the paper highlights
    s2 = make_stage_tasks(
        job_id, 2, n_tasks=60, stage_input_bytes=share * 0.9,
        phases=[
            Phase("read", APIS["sortByKey"], 0.8),
            Phase("process", APIS["map"], 0.2),
        ],
        skew=0.3,
    )
    return JobSpec(job_id, [s0, s1, s2], submit_time=submit)


def make_pr(
    job_id: str = "pr",
    *,
    input_gb: float = 30.0,
    iterations: int = 5,
    submit: float = 0.0,
    cache_factor: float = 0.7,
) -> JobSpec:
    """PageRank: groupByKey links stage (cached), then N rank iterations.

    The link structure is cached in memory after the first stage and lives
    as long as the job (paper §VI-C) — this is the job-lifetime pressure
    source that pushes Spark into OME at ≤17 GB heaps.  Paper Table III:
    PR = 1500 tasks total over 6 stages → ~62/stage/executor.
    """
    share = input_gb * GB / 4.0
    n_tasks_per_stage = 1500 // (iterations + 1) // 4
    stages: List[List] = []
    # Stage 0: build + cache adjacency lists (groupByKey, linear) —
    # cache_on_complete materializes the job-lifetime cached RDD.
    stages.append(
        make_stage_tasks(
            job_id, 0, n_tasks=n_tasks_per_stage, stage_input_bytes=share,
            phases=[
                Phase("read", APIS["groupByKey"], 0.7),
                Phase("process", APIS["map"], 0.3),
            ],
            cache_total_bytes=share * cache_factor,
            skew=0.5,
        )
    )
    for it in range(1, iterations + 1):
        stages.append(
            make_stage_tasks(
                job_id, it, n_tasks=n_tasks_per_stage,
                stage_input_bytes=share * 0.6,
                phases=[
                    Phase("read", APIS["groupByKey"], 0.5),
                    Phase("process", APIS["map"], 0.2),
                    Phase("write", APIS["reduceByKey"], 0.3),
                ],
                # per-iteration rank RDD replaces the previous one; model the
                # steady-state increment as a small additional cache
                cache_total_bytes=share * 0.05,
                skew=0.5,
            )
        )
    return JobSpec(job_id, stages, submit_time=submit)


# --------------------------------------------------------------- experiment
def run_service(
    jobs: List[JobSpec],
    *,
    heap_gb: float,
    murs: Optional[MursConfig] = None,
    policy=None,
    cores: int = 16,
    dt: float = 0.05,
    gc: Optional[GcModel] = None,
    oom_is_fatal: bool = True,
) -> ServiceMetrics:
    """Run jobs concurrently in one shared context (service mode).

    ``policy`` takes any :class:`repro_torch.sched.SchedulingPolicy`; ``murs``
    (a config, or None for FAIR) is the legacy convenience spelling.
    """
    ex = ServiceExecutor(
        cores=cores,
        heap_bytes=heap_gb * GB,
        murs=murs,
        policy=policy,
        dt=dt,
        gc=gc or GcModel(),
        oom_is_fatal=oom_is_fatal,
    )
    for j in jobs:
        ex.submit(j)
    return ex.run()


def run_batch(
    jobs: List[JobSpec],
    *,
    heap_gb: float,
    cores: int = 16,
    dt: float = 0.05,
    gc: Optional[GcModel] = None,
) -> Dict[str, ServiceMetrics]:
    """Run jobs one-after-another, each in a fresh executor (batch mode)."""
    out: Dict[str, ServiceMetrics] = {}
    for j in jobs:
        ex = ServiceExecutor(
            cores=cores, heap_bytes=heap_gb * GB, murs=None, dt=dt,
            gc=gc or GcModel(),
        )
        ex.submit(replace(j, submit_time=0.0))
        out[j.job_id] = ex.run()
    return out
