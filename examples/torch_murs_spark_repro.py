"""Reproduce the paper's Spark evaluation scenarios (discrete-event env)
on the PyTorch port's copy of the simulator —
``examples/murs_spark_repro.py`` through ``repro_torch``.  Host only: the
simulator does no device arithmetic.

    PYTHONPATH=src python examples/torch_murs_spark_repro.py
"""

from repro_torch.core.spark_sim import (
    make_grep, make_pr, make_sort, make_wc, run_batch, run_service,
)
from repro_torch.sched import MursConfig


def show(tag, m):
    jobs = "  ".join(
        f"{j}: exec={jm.exec_time:.0f}s gc={jm.gc_time:.0f}s spills={jm.spills}"
        for j, jm in m.jobs.items()
    )
    print(f"{tag:28s} {jobs}")


def main() -> None:
    print("— Fig 1 motivation: WC suffers PR's pressure in service mode —")
    show("service (FAIR):", run_service([make_pr(), make_wc()], heap_gb=15,
                                        oom_is_fatal=False))
    batch = run_batch([make_pr(), make_wc()], heap_gb=15)
    for j, m in batch.items():
        show(f"batch ({j} alone):", m)

    print("\n— no-caching group (Sort+WC+Grep), 6 GB heap —")

    def jobs():
        return [make_sort(), make_wc(), make_grep()]

    show("FAIR:", run_service(jobs(), heap_gb=6, oom_is_fatal=False))
    show("MURS:", run_service(jobs(), heap_gb=6, murs=MursConfig(),
                              oom_is_fatal=False))


if __name__ == "__main__":
    main()
