"""The port's serving cluster against the JAX package's.

Fixed op streams of ``tests/test_cluster.py``'s and
``tests/test_ckpt_restore.py``'s kinds go through both clusters on
internlm2-1.8b smoke with the same parameters (bf16 crossing as a uint16
view): routing, straggler migration, a crash with and without KV
checkpoints, a delta cutover and a mid-decode migration.  The homes,
the completed / failed / lost sets, the migration and checkpoint counts
and bytes, the restore outcomes and the tick count must be equal; the
greedy tokens equal, or a documented bf16 near-tie (the rule of
``tests/test_torch_serve.py``).

Two things differ by design and are handled here:

* The straggler pass reads each replica's modeled tick cost
  (``ServingEngine.last_tick_cost``); the port prices it with the H100's
  constants (``repro_torch/roofline/analysis.py``), the reference with
  the TPU's (``src/repro/roofline/analysis.py``).  So that flags can
  differ only by code, the parity runs give the port's engines the
  reference's constants through ``monkeypatch`` of the engine's
  ``tick_cost_model``; the package keeps the H100's.
* The port repairs a fault of the reference (ROADMAP Queue 3): an
  export of a replica's running request resumes the policy's FIFO head,
  as a completion does.  Parity is compared only on streams where no
  export takes a running request off a source that keeps a suspended
  one, and each parity run checks that this never happened.  The Queue 3
  stream shows the difference: every port request ends terminal exactly
  once, while the reference leaves q0 and q3 unfinished.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.roofline.analysis as jroofline  # noqa: E402
from repro import sched as jsched  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models import init_model, prefill  # noqa: E402
from repro.serve.kv_cache import kv_bytes_per_token  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import _msgpack  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

#: the logit tolerance stated (and measured) in test_torch_model.py
LOGIT_ATOL = 0.1

CFG = ARCHS["internlm2-1.8b"].smoke()
TCFG = TARCHS["internlm2-1.8b"].smoke()


@pytest.fixture(scope="module")
def params():
    p = init_model(CFG, jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.fixture
def reference_costs(monkeypatch):
    """Price the port's ticks with the reference's (TPU) constants."""
    build = tengine.tick_cost_model

    def priced(cfg, page_tokens=16):
        return dataclasses.replace(
            build(cfg, page_tokens), hbm_bw=jroofline.HBM_BW,
            peak_flops=jroofline.PEAK_FLOPS, pcie_bw=jroofline.PCIE_BW)

    monkeypatch.setattr(tengine, "tick_cost_model", priced)


@pytest.fixture
def stranding_exports(monkeypatch):
    """Every port export that takes a running request off a replica that
    keeps a suspended one: the case the port's repair changes."""
    seen = []
    export = tserve.ServingEngine.export_request

    def watched(self, request_id, baseline=None):
        req = self._live.get(request_id)
        running = req is not None and req.state in ("prefill", "decoding")
        ticket = export(self, request_id, baseline)
        if running and any(r.state == "suspended"
                           for r in self._live.values()):
            seen.append(request_id)
        return ticket

    monkeypatch.setattr(tserve.ServingEngine, "export_request", watched)
    return seen


def _factory(port, tokens, n_slots, policy="murs"):
    sched, serve = (tsched, tserve) if port else (jsched, jserve)
    cap = kv_bytes_per_token(CFG) * tokens
    kw = {"device": "cpu"} if port else {}

    def make():
        pol = {
            "murs": lambda: sched.MursPolicy(
                sched.MursConfig.for_serving(period=1.0)),
            "fair": sched.FairPolicy,
            "default": lambda: None,
        }[policy]()
        return serve.EngineConfig(n_slots=n_slots, max_seq=64,
                                  hbm_capacity_bytes=cap, policy=pol, **kw)

    return make


def _cluster(port, params, *, tokens=80, n_slots=3, engine="murs",
             router="murs", **ccfg):
    sched, serve = (tsched, tserve) if port else (jsched, jserve)
    router = {"murs": lambda: sched.MursPolicy(sched.MursConfig.for_serving()),
              "fair": sched.FairPolicy, "none": lambda: None}[router]()
    return serve.ServingCluster(
        TCFG if port else CFG, params[1] if port else params[0],
        serve.ClusterConfig(engine=_factory(port, tokens, n_slots, engine),
                            router=router, **ccfg),
    )


def _prompts(n):
    return [[2 + (7 * i + j) % 40 for j in range(6 + i)] for i in range(n)]


#: name → (cluster keywords, ops).  An op is ("submit", rid, tenant,
#: prompt, max_new), ("step", n), ("slow", replica, factor), ("crash",
#: replica), ("migrate", rid), ("drain", replica) or ("run", max_ticks).
STREAMS = {
    # tests/test_cluster.py::TestRouting
    "route_fair": (
        dict(engine="fair", router="fair", n_replicas=2),
        [("submit", f"r{i}", "T", list(range(4)), 4) for i in range(4)]
        + [("step", 1), ("run", 300)],
    ),
    "route_murs": (
        dict(n_replicas=2),
        [("submit", "H0", "A", list(range(10, 18)), 40),
         ("submit", "L0", "B", list(range(30, 34)), 4),
         ("submit", "H1", "A", list(range(10, 18)), 40),
         ("submit", "L1", "B", list(range(30, 34)), 4),
         ("step", 1), ("run", 400)],
    ),
    # TestStragglerPass::test_straggler_triggers_live_migration
    "straggler": (
        dict(n_replicas=2, straggler_min_samples=4),
        [("submit", f"A{i}", "A", list(range(10, 18)), 24) for i in range(4)]
        + [("slow", 0, 8.0), ("run", 400)],
    ),
    # TestCrashRecovery::test_crash_requeues_and_completes_everything
    "crash_cold": (
        dict(n_replicas=2, max_retries=3, retry_backoff_ticks=1.0,
             max_backoff_ticks=4.0, engine="default", router="none"),
        [("submit", f"C{i}", "A", list(range(10, 18)), 10) for i in range(4)]
        + [("step", 6), ("crash", 0), ("run", 600)],
    ),
    # test_ckpt_restore.py's crash/restore stream at fixed ops
    "crash_checkpoint": (
        dict(tokens=120, n_replicas=2, max_retries=4,
             retry_backoff_ticks=1.0, max_backoff_ticks=2.0,
             checkpoint_every_ticks=3, engine="default", router="none"),
        [("submit", f"q{i}", "T", p, 8) for i, p in enumerate(_prompts(3))]
        + [("step", 5), ("crash", 0), ("step", 4), ("crash", 1),
           ("run", 800)],
    ),
    # an operator drain: pre-copy in the background, delta cutover
    "delta_cutover": (
        dict(tokens=200, n_slots=2, n_replicas=2, engine="default",
             router="none", net_bytes_per_tick=20_000.0),
        [("submit", f"d{i}", "T", list(range(2, 20)), 24) for i in range(2)]
        + [("step", 6), ("drain", 0), ("run", 400)],
    ),
    # TestMigrationRoundTrip::test_mid_decode_migration_identical_tokens
    "mid_decode_migration": (
        dict(tokens=200, n_slots=2, n_replicas=2, engine="murs",
             router="none"),
        [("submit", "r", "T", list(range(10, 18)), 16), ("step", 6),
         ("migrate", "r"), ("run", 300)],
    ),
}


def _drive(cl, ops, tokens):
    """Apply ``ops``; ``tokens`` collects each request's tokens at
    completion (a later crash of its replica forgets them)."""
    def harvest():
        for eng in cl.replicas:
            for rid, r in eng.requests.items():
                if r.state == "done":
                    tokens[rid] = list(r.generated)

    serve = tserve if isinstance(cl, tserve.ServingCluster) else jserve
    first_homes = None
    for op in ops:
        kind = op[0]
        if kind == "submit":
            cl.submit(serve.Request(op[1], op[2], list(op[3]), op[4]))
        elif kind == "step":
            for _ in range(op[1]):
                cl.step()
                harvest()
            if first_homes is None:
                first_homes = dict(cl._home)
        elif kind == "slow":
            cl.set_slowdown(op[1], op[2])
        elif kind == "crash":
            cl.crash_replica(op[1])
        elif kind == "migrate":
            assert cl.migrate(op[1], cl._home[op[1]])
        elif kind == "drain":
            assert cl.drain_replica(op[1]) >= 1
        elif kind == "run":
            while cl.has_pending and cl.tick < op[1]:
                cl.step()
                harvest()
    out = cl.run(max_ticks=0).extras
    out["first_homes"] = first_homes
    return out


def _summary(cl, out):
    keep = ("first_homes", "completed", "failed", "lost",
            "in_flight_unfinished", "crashes", "requeued",
            "straggler_flags", "migrations", "delta_migration",
            "checkpoint", "ticks", "submitted")
    return (dict(cl._home), sorted(cl.completed), sorted(cl.failed),
            sorted(cl.lost), {k: out[k] for k in keep})


def _margin(jparams, tokens):
    logits, _ = prefill(CFG, jparams, jnp.asarray([tokens], jnp.int32))
    top = np.sort(np.asarray(logits[0, -1]))[::-1]
    return float(top[0] - top[1])


def _prompt_of(cl, rid):
    for eng in cl.replicas:
        if rid in eng.requests:
            return list(eng.requests[rid].prompt)
    return None


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_equals_reference(params, name, tmp_path, reference_costs,
                                 stranding_exports):
    ccfg, ops = STREAMS[name]
    runs = {}
    for port in (False, True):
        kw = dict(ccfg)
        if "checkpoint_every_ticks" in kw:
            kw["checkpoint_dir"] = str(tmp_path / ("port" if port else "jax"))
        cl = _cluster(port, params, **kw)
        toks = {}
        out = _drive(cl, ops, toks)
        runs[port] = (cl, out, toks)
    assert stranding_exports == []  # the port's repair never fired
    (jcl, jout, jtok), (tcl, tout, ttok) = runs[False], runs[True]
    assert _summary(tcl, tout) == _summary(jcl, jout)
    submitted = {op[1] for op in ops if op[0] == "submit"}
    assert sorted(tcl.completed) == sorted(submitted)
    assert tout["failed"] == tout["lost"] == tout["in_flight_unfinished"] == 0
    flips = []
    for rid in sorted(submitted):
        a, b = jtok[rid], ttok[rid]
        if a == b:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = _margin(params[0], _prompt_of(jcl, rid) + a[:k])
        assert margin < LOGIT_ATOL, (rid, k, margin)
        flips.append((rid, k, margin))
    assert len(flips) <= 1, flips
    # each stream exercises what it is named for
    expect = {
        "straggler": lambda o: o["straggler_flags"] >= 1
        and o["migrations"]["completed"] >= 1,
        "crash_cold": lambda o: o["crashes"] == 1 and o["requeued"] > 0,
        "crash_checkpoint": lambda o: o["checkpoint"]["restored_requests"]
        >= 1 and o["checkpoint"]["saved"] >= 1,
        "delta_cutover": lambda o: o["delta_migration"]["delta_cutovers"]
        >= 1,
        "mid_decode_migration": lambda o: o["migrations"]["completed"] == 1,
    }.get(name, lambda o: True)
    assert expect(tout), tout
    if name == "route_fair":  # round-robin, alternating
        assert [tout["first_homes"][f"r{i}"] for i in range(4)] in (
            [0, 1, 0, 1], [1, 0, 1, 0])
    if name == "route_murs":  # demand-aware: the heavy two split
        assert tout["first_homes"]["H0"] != tout["first_homes"]["H1"]


# ------------------------------------------------------------ checkpoints
def _ckpt_cluster(port, params, directory):
    return _cluster(port, params, tokens=120, n_replicas=1,
                    checkpoint_every_ticks=4, checkpoint_dir=directory,
                    engine="default", router="none")


def test_kv_checkpoints_cross_between_packages(params, tmp_path):
    """A KV checkpoint written by either cluster reads in the other with
    the same manifest and the same page payload bytes; both clusters
    write the same manifests."""
    clusters = {}
    for port in (False, True):
        cl = _ckpt_cluster(port, params,
                           str(tmp_path / ("port" if port else "jax")))
        serve = tserve if port else jserve
        for i, p in enumerate(_prompts(2)):
            cl.submit(serve.Request(f"q{i}", "T", list(p), 12))
        for _ in range(9):
            cl.step()
        assert cl.ckpt_saved == 2
        clusters[port] = cl
    reads = {}
    for writer in (False, True):
        for reader in (False, True):
            cl = clusters[reader]
            cl.ccfg.checkpoint_dir = str(tmp_path / ("port" if writer
                                                     else "jax"))
            reads[writer, reader] = cl._read_checkpoint(0)
    for writer in (False, True):
        a, b = reads[writer, False], reads[writer, True]
        assert a.keys() == b.keys() and a
        for rid in a:
            assert a[rid]["pos"] == b[rid]["pos"]
            assert a[rid]["generated"] == b[rid]["generated"]
            assert a[rid]["pages"].keys() == b[rid]["pages"].keys()
            for idx in a[rid]["pages"]:
                x, y = a[rid]["pages"][idx], b[rid]["pages"][idx]
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    jm, tm = reads[False, False], reads[True, True]
    assert {r: (e["pos"], sorted(e["pages"])) for r, e in jm.items()} == {
        r: (e["pos"], sorted(e["pages"])) for r, e in tm.items()}


def test_checkpoint_manifest_is_msgpack(params, tmp_path):
    """The manifest leaf is the port codec's bytes of the manifest, read
    back to the payloads a fresh ``snapshot_kv`` gives."""
    import msgpack

    from repro_torch.checkpoint import latest_step_path, restore_leaves

    cl = _ckpt_cluster(True, params, str(tmp_path))
    for i, p in enumerate(_prompts(2)):
        cl.submit(tserve.Request(f"q{i}", "T", list(p), 12))
    for _ in range(5):  # the tick-4 checkpoint is the state after step 4
        cl.step()
    leaves, step = restore_leaves(latest_step_path(str(tmp_path / "r0")))
    assert step == 4
    manifest = _msgpack.unpackb(leaves[0].tobytes())
    assert manifest == msgpack.unpackb(leaves[0].tobytes(), raw=False)
    assert leaves[0].tobytes() == msgpack.packb(manifest, use_bin_type=True)
    assert len(leaves) == 1 + sum(len(e["pages"]) for e in manifest["reqs"])


# ------------------------------------------------------------ Queue 3 fault
#: tests/test_cluster.py::TestNoLossNoDuplication's example that strands a
#: suspended request in the reference (ROADMAP Queue 3)
QUEUE3_OPS = [("step", 0), ("submit", 3), ("crash", 0), ("step", 0),
              ("step", 0), ("submit", 0), ("submit", 0), ("submit", 1),
              ("step", 0), ("crash", 0), ("crash", 0), ("step", 0),
              ("submit", 0), ("migrate", 3)]


def _property_run(port, params, ops):
    """TestNoLossNoDuplication's interpretation of an op stream."""
    serve = tserve if port else jserve
    cl = _cluster(port, params, tokens=60, n_slots=2, router="none",
                  n_replicas=2, max_retries=2, retry_backoff_ticks=1.0,
                  max_backoff_ticks=2.0, straggler_min_samples=4)
    submitted, n_crashes = [], 0
    for kind, arg in ops:
        if kind == "submit" and len(submitted) < 5:
            rid = f"q{len(submitted)}"
            submitted.append(rid)
            cl.submit(serve.Request(rid, f"T{arg % 2}", list(range(6)), 6))
        elif kind == "step":
            for _ in range(1 + arg % 3):
                cl.step()
        elif kind == "migrate":
            src = arg % 2
            victims = cl.replicas[src].migratable_requests()
            if victims:
                cl.migrate(victims[arg % len(victims)][0], src)
        elif kind == "crash" and n_crashes < 2:
            n_crashes += 1
            cl.crash_replica(arg % 2)
    out = cl.run(max_ticks=500).extras
    return cl, out, submitted


def _assert_terminal_once(cl, out, submitted):
    assert out["in_flight_unfinished"] == 0
    assert sorted(cl.completed + cl.failed) == sorted(submitted)
    for rid in submitted:
        assert sum(rid in eng.requests for eng in cl.replicas) <= 1


def test_queue3_stream_reference_strands_port_does_not(
        params, reference_costs, stranding_exports):
    jcl, jout, submitted = _property_run(False, params, QUEUE3_OPS)
    # the reference: q3 stays suspended behind MURS's FIFO and q0 queued
    # behind it, to the tick budget; neither completes nor fails
    assert jout["ticks"] == 500
    assert sorted(jcl.completed + jcl.failed) == ["q1", "q2", "q4"]
    r1 = jcl.replicas[1]
    assert {rid: r.state for rid, r in r1._live.items()} == {
        "q3": "suspended", "q0": "queued"}
    assert tuple(r1.policy.suspended_queue) == ("q3",)
    # the port on the same stream and the same tick prices: the export of
    # q1, replica 1's last running request, resumes q3
    tcl, tout, submitted = _property_run(True, params, QUEUE3_OPS)
    assert stranding_exports == ["q1"]
    _assert_terminal_once(tcl, tout, submitted)
    assert sorted(tcl.completed) == submitted and tout["ticks"] < 500


def test_queue3_stream_terminal_at_h100_prices(params):
    tcl, tout, submitted = _property_run(True, params, QUEUE3_OPS)
    _assert_terminal_once(tcl, tout, submitted)


@settings(max_examples=10, deadline=None)
@given(
    ops=st.lists(
        st.tuples(
            st.sampled_from(["step", "migrate", "crash", "submit"]),
            st.integers(min_value=0, max_value=5),
        ),
        min_size=4,
        max_size=14,
    )
)
def test_random_submit_migrate_crash_stream(params, ops):
    """tests/test_cluster.py's property on the port alone: every
    submitted request ends terminal exactly once, on at most one
    replica."""
    _assert_terminal_once(*_property_run(True, params, ops))
