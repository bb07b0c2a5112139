"""Multi-tenant serving under memory pressure on the PyTorch port: MURS
vs FAIR (the paper's service-mode scenario) —
``examples/serve_multitenant.py`` through ``repro_torch``.

    PYTHONPATH=src python examples/torch_serve_multitenant.py                # the card
    PYTHONPATH=src python examples/torch_serve_multitenant.py --device cpu   # no card

``--device cuda`` (the default) fails where there is no card.
"""

import argparse

from repro_torch.configs import ARCHS
from repro_torch.models import init_model
from repro_torch.sched import FairPolicy, MursConfig, MursPolicy
from repro_torch.serve import EngineConfig, Request, ServingEngine
from repro_torch.serve.kv_cache import kv_bytes_per_token


def workload():
    """Tenant A: long heavy generations; tenant B: short interactive ones."""
    reqs = [Request(f"A{i}", "A", list(range(10, 18)), 40) for i in range(3)]
    reqs += [Request(f"B{i}", "B", list(range(30, 34)), 6) for i in range(4)]
    return reqs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails where there is no card")
    args = ap.parse_args()

    cfg = ARCHS["internlm2-1.8b"].smoke()
    params = init_model(cfg, 0, device=args.device)
    capacity = kv_bytes_per_token(cfg) * 80  # KV pool ≈ 80 tokens → pressure

    policies = (
        ("FAIR (stock)", FairPolicy()),
        ("MURS", MursPolicy(MursConfig.for_serving(period=1.0))),
    )
    for name, policy in policies:
        engine = ServingEngine(
            cfg, params,
            EngineConfig(n_slots=4, max_seq=64, hbm_capacity_bytes=capacity,
                         policy=policy, device=args.device),
        )
        for r in workload():
            engine.submit(r)
        rep = engine.run(max_ticks=400)
        print(f"{name:14s} completed {rep.completed}/7  "
              f"failed {rep.failed}  "
              f"suspensions {rep.extras['suspensions']}  "
              f"tokens {rep.tokens_generated}  "
              f"peak pool {rep.extras['peak_used_fraction']:.2f}")


if __name__ == "__main__":
    main()
