#!/usr/bin/env python3
"""Where a serving tick's time goes on one NVIDIA GPU (an H100).

Run from the root of a checkout::

    python3 chip_profile.py                                # internlm2-1.8b
    python3 chip_profile.py --arch granite-moe-3b-a800m    # the MoE model
    python3 chip_profile.py --arch mamba2-2.7b             # Mamba-2
    python3 chip_profile.py --arch zamba2-1.2b             # the hybrid

or, without the profiler, the host side of the same schedule::

    python3 chip_profile.py --arch granite-moe-3b-a800m --host 3

Serves ``chip_smoke.py``'s B and C tenants on full-width internlm2-1.8b,
or its whole granite-moe, mamba2 or zamba2 schedule (random bf16 weights
from a seed), through the port's MURS engine (the paged-decode kernel on
internlm2 and granite, the dense path on the SSM models), under
``torch.profiler``.  Prints one JSON line with the device's busy share of
the window, the kernels that take the most device time, each of the
port's kernels' device time and share of the busy time, the PyTorch
operators (with their input shapes) whose own device time is largest —
which tells a dtype cast of the unembedding weight from one of an
activation — and those whose own host time is largest, then the
``nvidia-smi`` name and power limit.  The profiler's own host cost lengthens the window,
so the busy share is a lower bound; it is null where the profiler saw no
device time.  ``--host N`` serves the schedule N more times with no
profiler and prints, for each, the wall time, the median decode-only
tick and the host time spent inside each port kernel's ``ops`` call
(the calls are not waited for, so this is the time the tick's host
thread spends there), for comparing two trees on a host-bound tick.
"""

import argparse
import sys
import time

import chip_smoke as smoke

PROFILED = ("internlm2-1.8b", "granite-moe-3b-a800m", "mamba2-2.7b",
            "zamba2-1.2b")
#: each port kernel's __global__ functions (csrc/*.cu)
PORT_KERNELS = {
    "paged_decode_attention": ("paged_decode_kernel",),
    "flash_attention": ("flash_kernel",),
    "decode_attention": ("decode_kernel",),
    "grouped_matmul": ("gmm_tma_kernel", "gmm_simple_kernel"),
    "ssd_scan": ("ssd_chunk_state_kernel", "ssd_tile_output_kernel",
                 "ssd_one_chunk_kernel"),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=PROFILED[0], choices=PROFILED)
    ap.add_argument("--host", type=int, default=0, metavar="N",
                    help="serve N times without the profiler and print "
                         "the host time inside the port kernels' calls")
    args = ap.parse_args()
    arch = args.arch
    sys.path.insert(0, str(smoke.SRC))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_model

    cfg = ARCHS[arch]
    params = init_model(cfg, smoke.SEED, device=smoke.DEV)

    def engine(warm=False):
        if cfg.moe is not None:
            return smoke.granite_engine(cfg, params, smoke.DEV)
        if cfg.ssm is not None:
            return smoke.ssm_engine(cfg, params, smoke.DEV)
        return smoke.serve_engine(cfg, params, ("B",) if warm else ("B", "C"),
                                  False)

    # a first run outside the window builds the kernels and warms the caches
    smoke.drive(*engine(warm=True))
    if args.host:
        return host_runs(torch, cfg, engine, args.host)
    eng, sched = engine()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        ticks = smoke.drive(eng, sched)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for evt in cuda:
        by_name[evt.name] = (by_name.get(evt.name, 0.0)
                             + evt.time_range.elapsed_us())
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # device time of the port's own kernels, by the __global__ names of
    # their CUDA sources (K6 runs two per launch past one chunk, one
    # within it)
    port_us = {
        k: sum(us for n, us in by_name.items() if any(g in n for g in names))
        for k, names in PORT_KERNELS.items()
    }
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.self_device_time_total > 0]
    top_ops = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
    host_ops = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:10]
    smoke.emit({"phase": "profile", "arch": cfg.name, "ticks": len(ticks),
                "wall_ms": wall_us / 1e3,
                "device_busy_ms": busy / 1e3 if busy else None,
                "device_busy_share": busy / wall_us if busy else None,
                "kernel_launches": len(cuda),
                "top_kernels_ms": [[n[:90], us / 1e3] for n, us in top],
                "port_kernels_ms": {k: us / 1e3 for k, us in port_us.items()},
                "port_kernels_share_of_busy": {
                    k: us / busy if busy else None
                    for k, us in port_us.items()},
                "top_ops_self_device_ms": [
                    [e.key, str(e.input_shapes)[:120], e.count,
                     e.self_device_time_total / 1e3] for e in top_ops],
                "top_ops_self_host_ms": [
                    [e.key, e.count, e.self_cpu_time_total / 1e3]
                    for e in host_ops]})
    print(smoke.nvidia_smi(), flush=True)
    return 0


def host_runs(torch, cfg, engine, repeats):
    """Serve ``repeats`` times with each port kernel's ``ops`` call timed
    on the host; one JSON line a run."""
    import statistics

    from repro_torch.kernels import ops

    spent, calls = {}, {}

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return wrapped

    names = [fn.__name__ for fn in ops.WRAPPERS]
    for name in names:  # the model calls them through ``ops``
        setattr(ops, name, timed(name, getattr(ops, name)))
    for run in range(repeats):
        spent.update(dict.fromkeys(names, 0.0))
        calls.update(dict.fromkeys(names, 0))
        eng, sched = engine()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ticks = smoke.drive(eng, sched)
        torch.cuda.synchronize()
        decode = [ms for ms, token, chunked in ticks if token and not chunked]
        smoke.emit({"phase": "host", "arch": cfg.name, "run": run,
                    "ticks": len(ticks),
                    "wall_s": time.perf_counter() - t0,
                    "median_decode_only_tick_ms": statistics.median(decode),
                    "host_ms_in_call": {n: 1e3 * spent[n] for n in names
                                        if calls[n]},
                    "calls": {n: calls[n] for n in names if calls[n]}})
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
