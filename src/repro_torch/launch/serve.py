"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Boots the multi-tenant engine (MURS admission by default; ``--fair`` for
the stock baseline) on the smoke-size model and runs a synthetic
two-tenant workload.  Runs on the card unless ``--device cpu``.  Every
architecture of ``ARCHS`` is a choice; the two whose prefill needs
front-end inputs (whisper-base, internvl2-26b) are refused with the
engine's :class:`ExtraInputsNotServed` message and exit status 1.
"""

import argparse

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import init_model
from repro_torch.sched import FairPolicy, MursConfig, MursPolicy
from repro_torch.serve import (
    EngineConfig,
    ExtraInputsNotServed,
    Request,
    ServingEngine,
)
from repro_torch.serve.kv_cache import kv_bytes_per_token


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=sorted(ARCHS))
    ap.add_argument("--fair", action="store_true", help="disable MURS")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--pool-tokens", type=int, default=80,
                    help="KV pool capacity in token-equivalents")
    ap.add_argument("--requests", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails where there is no card")
    args = ap.parse_args()

    # full-precision f32 matmuls: no TF32 anywhere in the port
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(args.arch).smoke()
    params = init_model(cfg, 0, device=args.device)
    capacity = max(kv_bytes_per_token(cfg), 1.0) * args.pool_tokens
    try:
        engine = ServingEngine(
            cfg, params,
            EngineConfig(
                n_slots=args.slots,
                max_seq=args.max_seq,
                hbm_capacity_bytes=capacity,
                policy=(FairPolicy() if args.fair
                        else MursPolicy(MursConfig.for_serving(period=1.0))),
                device=args.device,
            ),
        )
    except ExtraInputsNotServed as exc:
        raise SystemExit(f"launch.serve: {exc}") from None
    n_a = args.requests // 2 + args.requests % 2
    for i in range(n_a):
        engine.submit(Request(f"A{i}", "A", list(range(10, 18)), 40))
    for i in range(args.requests - n_a):
        engine.submit(Request(f"B{i}", "B", list(range(30, 34)), 6))
    rep = engine.run(max_ticks=1000)
    mode = "FAIR" if args.fair else "MURS"
    print(f"[{mode}] completed {rep.completed}/{args.requests}  "
          f"failed {rep.failed}  "
          f"suspensions {rep.extras['suspensions']}  "
          f"tokens {rep.tokens_generated}  "
          f"peak pool {rep.extras['peak_used_fraction']:.2f}")


if __name__ == "__main__":
    main()
