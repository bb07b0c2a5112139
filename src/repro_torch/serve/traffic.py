"""Open-loop arrival traces: seeded Poisson / diurnal / bursty traffic.

The benchmark legs before this module drove ~6 closed-loop requests —
one in, one out — which never exercises the paper's failure mode: a
service-oriented system breaks when *many concurrently submitted tasks*
share one memory context (MURS §II).  An OPEN-LOOP generator submits on
the trace's schedule regardless of completions, so queue depth and
projected demand grow without bound unless admission control sheds.

Every trace is a deterministic function of its seed (``random.Random``;
no wall clock), so benchmark runs are reproducible bit-for-bit.  Traces
are thinned from a max-rate Poisson process, which makes the diurnal and
bursty shapes exact (not per-tick approximations) and keeps all three
generators on one code path.

:func:`drive` pushes a trace through anything satisfying
:class:`repro_torch.serve.server.Server` — engine, cluster, or the admission
front door — and returns the run's :class:`ServeReport`.
"""

from __future__ import annotations

import math
import random
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

from repro_torch.serve.engine import Request
from repro_torch.serve.report import ServeReport
from repro_torch.serve.server import Server

__all__ = [
    "Arrival",
    "TenantProfile",
    "bursty_trace",
    "diurnal_trace",
    "drive",
    "poisson_trace",
]


@dataclass(frozen=True)
class TenantProfile:
    """Per-tenant request-shape distribution.

    ``weight`` is the tenant's share of arrivals; prompt/output lengths
    draw uniformly from the inclusive ranges.  ``vocab`` bounds the
    synthetic token ids (kept small so prompts rarely collide with the
    prefix cache unless a test wants them to).
    """

    name: str
    weight: float = 1.0
    prompt_tokens: Tuple[int, int] = (4, 8)
    output_tokens: Tuple[int, int] = (4, 16)
    vocab: int = 31

    def make_request(self, rnd: random.Random, index: int) -> Request:
        """Draw one request from the tenant's prompt/output ranges."""
        prompt = [
            1 + rnd.randrange(self.vocab)
            for _ in range(rnd.randint(*self.prompt_tokens))
        ]
        return Request(
            request_id=f"{self.name}-{index}",
            tenant=self.name,
            prompt=prompt,
            max_new_tokens=rnd.randint(*self.output_tokens),
        )


@dataclass(frozen=True)
class Arrival:
    """One traced arrival: the tick it lands and the request itself."""

    tick: int
    request: Request


def _thinned_trace(
    tenants: Sequence[TenantProfile],
    n_requests: int,
    seed: int,
    rate_fn: Callable[[float], float],
    rate_max: float,
    start_tick: int,
) -> List[Arrival]:
    """Draw ``n_requests`` arrivals from an inhomogeneous Poisson process
    with instantaneous rate ``rate_fn(t) <= rate_max`` via thinning."""
    if not tenants:
        raise ValueError("at least one TenantProfile required")
    if rate_max <= 0:
        raise ValueError(f"rate must be positive, got {rate_max}")
    rnd = random.Random(seed)
    total_w = sum(t.weight for t in tenants)
    counts = {t.name: 0 for t in tenants}
    t_now = float(start_tick)
    out: List[Arrival] = []
    while len(out) < n_requests:
        t_now += rnd.expovariate(rate_max)
        if rnd.random() * rate_max > rate_fn(t_now):
            continue
        x = rnd.random() * total_w
        profile = tenants[-1]
        for tp in tenants:
            x -= tp.weight
            if x <= 0:
                profile = tp
                break
        req = profile.make_request(rnd, counts[profile.name])
        counts[profile.name] += 1
        out.append(Arrival(int(t_now), req))
    return out


def poisson_trace(
    tenants: Sequence[TenantProfile],
    *,
    rate_per_tick: float,
    n_requests: int,
    seed: int = 0,
    start_tick: int = 0,
) -> List[Arrival]:
    """Homogeneous Poisson arrivals at ``rate_per_tick``."""
    return _thinned_trace(
        tenants,
        n_requests,
        seed,
        lambda _t: rate_per_tick,
        rate_per_tick,
        start_tick,
    )


def diurnal_trace(
    tenants: Sequence[TenantProfile],
    *,
    base_rate_per_tick: float,
    n_requests: int,
    period_ticks: float = 200.0,
    amplitude: float = 0.5,
    seed: int = 0,
    start_tick: int = 0,
) -> List[Arrival]:
    """Sinusoidal day/night load: rate(t) = base·(1 + amplitude·sin)."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")

    def rate(t: float) -> float:
        return base_rate_per_tick * (
            1.0 + amplitude * math.sin(2.0 * math.pi * t / period_ticks)
        )

    return _thinned_trace(
        tenants,
        n_requests,
        seed,
        rate,
        base_rate_per_tick * (1.0 + amplitude),
        start_tick,
    )


def bursty_trace(
    tenants: Sequence[TenantProfile],
    *,
    rate_per_tick: float,
    n_requests: int,
    burst_factor: float = 4.0,
    burst_ticks: float = 20.0,
    gap_ticks: float = 80.0,
    seed: int = 0,
    start_tick: int = 0,
) -> List[Arrival]:
    """Square-wave load: ``burst_factor``× the base rate for
    ``burst_ticks``, then the base rate for ``gap_ticks``, repeating."""
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    cycle = burst_ticks + gap_ticks

    def rate(t: float) -> float:
        in_burst = (t - start_tick) % cycle < burst_ticks
        return rate_per_tick * (burst_factor if in_burst else 1.0)

    return _thinned_trace(
        tenants,
        n_requests,
        seed,
        rate,
        rate_per_tick * burst_factor,
        start_tick,
    )


def drive(
    server: Server, arrivals: Sequence[Arrival], *, max_ticks: int = 5000
) -> ServeReport:
    """Open-loop driver: submit each arrival at its trace tick — never
    waiting on completions — then drain the server within the remaining
    tick budget and return its typed report.

    Arrivals whose tick falls past ``max_ticks`` are never submitted
    (the run ended before they "happened"); everything submitted is
    accounted for in the report's outcome rows.
    """
    pending = deque(sorted(arrivals, key=lambda a: a.tick))  # stable: same-tick order kept
    while pending and server.tick <= max_ticks:
        while pending and pending[0].tick <= server.tick:
            server.submit(pending.popleft().request)
        if not pending:
            break
        server.step()
    return server.run(max_ticks=max_ticks)
