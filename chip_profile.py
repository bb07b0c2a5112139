#!/usr/bin/env python3
"""Where a serving tick's time goes on one NVIDIA GPU (an H100).

Run from the root of a checkout, with no arguments::

    python3 chip_profile.py

Serves ``chip_smoke.py``'s B and C tenants on full-width internlm2-1.8b
(random bf16 weights from a seed) through the port's MURS engine and the
f32 paged-decode kernel, under ``torch.profiler``.  Prints one JSON line
with the device's busy share of the window and the kernels that take the
most device time, then the ``nvidia-smi`` name and power limit.  The
profiler's own host cost lengthens the window, so the busy share is a
lower bound; it is null where the profiler saw no device time.
"""

import sys
import time

import chip_smoke as smoke


def main() -> int:
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

    cfg = ARCHS["internlm2-1.8b"]
    params = init_model(cfg, smoke.SEED, device=smoke.DEV)
    # a first run outside the window builds the kernel and warms the caches
    smoke.drive(*smoke.serve_engine(cfg, params, ("B",), False))
    eng, sched = smoke.serve_engine(cfg, params, ("B", "C"), False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    smoke.emit({"phase": "profile", "ticks": len(ticks),
                "wall_ms": wall_us / 1e3,
                "device_busy_ms": busy / 1e3 if busy else None,
                "device_busy_share": busy / wall_us if busy else None,
                "kernel_launches": len(cuda),
                "top_kernels_ms": [[n[:90], us / 1e3] for n, us in top]})
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
