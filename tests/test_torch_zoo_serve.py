"""The port's MURS engine serving deepseek-v2, stablelm and qwen1.5 against
the JAX engine, at ``.smoke()``, on the same parameters (the JAX
package's ``init_model`` carried across by ``params_from_numpy``).

``tests/test_paged_serving.py``'s pressure trace (two heavy A requests,
three light B requests, three C requests sharing a 16-token prefix)
under ``MursPolicy`` over a 6-page pool, so requests are suspended and
prefixes hit.  stablelm and qwen decode on the paged path (K1 on the
card); deepseek's MLA latents keep the dense path, as in the JAX
package, with every slot, snapshot and page payload made of MLA leaves.
Scheduling outcomes must be equal exactly; the generated tokens equal,
or differ first where the JAX top-2 logit margin of the context is
under ``LOGIT_ATOL`` (a bf16 near-tie, the rule of
``tests/test_torch_serve.py``).  A deepseek request migrated between
two replicas of the port's cluster keeps its tokens.  The port's
launcher prints the JAX
launcher's line for deepseek (stablelm's and qwen's launcher runs take
~14 s each on a CPU and add nothing the engine runs above do not hold).
"""

import contextlib
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.sched import MursConfig, MursPolicy  # noqa: E402
from repro.serve import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import init_model as tm_init_model  # noqa: E402
from repro_torch.models import paged_decode_supported  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.kv_cache import kv_bytes_per_token  # noqa: E402

LOGIT_ATOL = 0.1  # bf16 logits, as tests/test_torch_model.py states
NAMES = ["deepseek-v2-236b", "stablelm-1.6b", "qwen1.5-110b"]


def _requests(cls):
    reqs = [cls(f"A{i}", "A", list(range(10, 18)), 24) for i in range(2)]
    reqs += [cls(f"B{i}", "B", list(range(30, 34)), 6) for i in range(3)]
    shared = list(range(50, 66))
    reqs += [cls(f"C{i}", "C", shared + [90 + i], 8) for i in range(3)]
    return reqs


@pytest.fixture(scope="module", params=NAMES)
def engines(request):
    name = request.param
    cfg, tcfg = ARCHS[name].smoke(), TARCHS[name].smoke()
    params = jm.init_model(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    # a 6-page pool: forces suspensions
    engine = dict(n_slots=3, max_seq=64,
                  hbm_capacity_bytes=kv_bytes_per_token(tcfg) * 16 * 6)
    j = ServingEngine(
        cfg, params,
        EngineConfig(policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                     **engine))
    t = tserve.ServingEngine(
        tcfg, tparams,
        tserve.EngineConfig(
            policy=tsched.MursPolicy(tsched.MursConfig.for_serving(
                period=1.0)),
            device="cpu", **engine))
    for eng, cls in ((j, Request), (t, tserve.Request)):
        for r in _requests(cls):
            eng.submit(r)
        eng.run(max_ticks=600)
    return cfg, params, j, t


def _rows(report):
    return [
        (o.request_id, o.tenant, o.outcome, o.submit_tick, o.finish_tick,
         o.first_token_tick, o.tokens, o.model)
        for o in report.outcomes
    ]


def test_engine_scheduling_outcomes_equal(engines):
    cfg, _, j, t = engines
    assert sorted(t.completed) == sorted(j.completed)
    assert len(t.completed) == 8 and not t.failed
    assert t.suspensions == j.suspensions > 0
    assert t.prefix_hits == j.prefix_hits > 0
    assert t.paged_decode_ticks == j.paged_decode_ticks
    assert (t.paged_decode_ticks > 0) == paged_decode_supported(
        TARCHS[cfg.name.removesuffix("-smoke")])
    assert t.tick == j.tick
    assert _rows(t.report()) == _rows(j.report())


def test_engine_tokens_equal_or_near_tie(engines):
    """Where a request's tokens differ, every earlier token agrees and
    the JAX top-2 margin at the first differing step is under
    ``LOGIT_ATOL``; requests with one prompt flip together, so a flip is
    counted once per distinct context."""
    cfg, params, j, t = engines
    flips = {}
    for rid in j.completed:
        jr, tr = j.requests[rid], t.requests[rid]
        if jr.generated == tr.generated:
            continue
        k = next(i for i, (a, b) in enumerate(zip(jr.generated, tr.generated))
                 if a != b)
        logits, _ = jm.prefill(
            cfg, params, jnp.asarray([jr.prompt + jr.generated[:k]],
                                     jnp.int32))
        top = np.sort(np.asarray(logits[0, -1]))[::-1]
        margin = float(top[0] - top[1])
        assert margin < LOGIT_ATOL, (rid, k, margin)
        flips.setdefault(tuple(jr.prompt + jr.generated[:k]), []).append(
            (rid, k, margin))
    assert len(flips) <= 2, flips


@pytest.mark.parametrize("name", ["deepseek-v2-236b"])
def test_launcher_line_equals_jax(name, monkeypatch):
    lines = []
    for main, extra in ((jlaunch.main, []),
                        (tlaunch.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv",
                            ["serve", "--arch", name, "--requests", "5",
                             *extra])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main()
        lines.append(out.getvalue().strip().splitlines()[-1])
    assert lines[0] == lines[1]
    assert lines[1].startswith("[MURS] completed 5/5")


def test_deepseek_request_migrates_with_its_mla_latents():
    """A deepseek-v2 request exported mid-decode from one replica and
    imported by another carries its MLA latent and rope-key caches: its
    tokens equal those of the same request served alone on one engine
    (the migration copies the slot's cache bit for bit, and every row of
    the dense step is its own MoE dispatch group)."""
    cfg = TARCHS["deepseek-v2-236b"].smoke()
    params = tm_init_model(cfg, 0, device="cpu")
    prompt = list(range(20, 44))

    def ecfg():
        return tserve.EngineConfig(n_slots=2, max_seq=64,
                                   hbm_capacity_bytes=1e9, device="cpu")

    ref = tserve.ServingEngine(cfg, params, ecfg())
    ref.submit(tserve.Request("m", "T", list(prompt), 12))
    ref.run(max_ticks=200)
    cl = tserve.ServingCluster(cfg, params, tserve.ClusterConfig(
        engine=ecfg, n_replicas=2, straggler_min_samples=10**9))
    cl.submit(tserve.Request("m", "T", list(prompt), 12))
    while cl.tick < 200:
        cl.step()
        src = cl._home["m"]
        if len(cl.replicas[src].requests["m"].generated) >= 4:
            break
    assert cl.migrate("m", src)
    out = cl.run(max_ticks=300).extras
    tgt = cl._home["m"]
    assert tgt != src and out["migrations"]["completed"] == 1
    got = cl.replicas[tgt].requests["m"].generated
    assert len(got) == 12 and got == ref.requests["m"].generated
