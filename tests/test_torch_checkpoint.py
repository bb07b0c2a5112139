"""The port's checkpoint format, codec and fault pieces against the JAX
package's.

* The port's MessagePack codec writes ``msgpack.packb(obj,
  use_bin_type=True)``'s bytes on a cluster manifest, a checkpoint
  container and edge values of every supported type, and reads them back.
* One tree (bf16, f32, int32 and uint8 leaves in nested dicts built in
  unsorted key order, a list and a tuple) saved by either package gives
  the same file bytes, and restores in the other bit for bit: under zstd
  and under zlib (forced by clearing both modules' ``zstandard``).
* ``restore``'s leaf-count check, ``restore_leaves``,
  ``latest_step_path`` and ``AsyncCheckpointer`` (an error surfaces on
  ``wait``) behave as the reference's do.
* ``StragglerDetector`` and ``RestartManager`` give the reference's
  flags, weights, backoffs and resumes on the same sequences.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.checkpoint import checkpointing as jckpt_mod  # noqa: E402
from repro.dist import fault as jfault  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.checkpoint import _msgpack  # noqa: E402
from repro_torch.checkpoint import checkpointing as tckpt_mod  # noqa: E402
from repro_torch.dist import fault as tfault  # noqa: E402


# --------------------------------------------------------------------- codec
def _manifest():
    return {"epoch": 41, "reqs": [
        {"rid": "chat-7", "pos": 70, "generated": [5, 92_000, 131, 0],
         "pages": [0, 1, 2, 3, 4]},
        {"rid": "bulk-12", "pos": 300, "generated": list(range(40)),
         "pages": list(range(19))},
    ]}


def _edge_values():
    ints = [0, 1, 127, 128, 255, 256, 65_535, 65_536, 2**32 - 1, 2**32,
            2**64 - 1, -1, -32, -33, -128, -129, -32_768, -32_769,
            -2**31, -2**31 - 1, -2**63]
    floats = [0.0, -0.0, 1.5, -2.25e-300, 1e300, float("inf"),
              float("-inf")]
    strs = ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40_000,
            "x" * 70_000]
    bins = [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65_536]
    containers = [[], list(range(15)), list(range(16)),
                  list(range(70_000)), tuple(range(3)),
                  {}, {f"k{i}": i for i in range(15)},
                  {f"k{i}": i for i in range(16)},
                  {"nested": {"deep": [None, True, False, {"z": b"bin"}]}}]
    return [None, True, False] + ints + floats + strs + bins + containers


@pytest.mark.parametrize("what", ["manifest", "container", "edges"])
def test_codec_bytes_equal_msgpack(what):
    leaf = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    obj = {
        "manifest": _manifest(),
        "container": {
            "meta": {"step": 96, "n_leaves": 2},
            "leaves": [
                {"dtype": "uint8", "shape": [7],
                 "data": _msgpack.packb(_manifest())},
                {"dtype": "float32", "shape": list(leaf.shape),
                 "data": leaf.tobytes()},
            ],
        },
        "edges": _edge_values(),
    }[what]
    ours = _msgpack.packb(obj)
    assert ours == msgpack.packb(obj, use_bin_type=True)
    back = _msgpack.unpackb(ours)
    assert back == msgpack.unpackb(ours, raw=False)
    assert _msgpack.unpackb(msgpack.packb(obj, use_bin_type=True)) == back


def test_codec_reads_float32_and_rejects_bad_input():
    assert _msgpack.unpackb(b"\xca" + np.float32(1.5).byteswap().tobytes()
                            ) == 1.5
    with pytest.raises(ValueError):
        _msgpack.unpackb(_msgpack.packb([1, 2, 3])[:-1])  # truncated
    with pytest.raises(ValueError):
        _msgpack.unpackb(_msgpack.packb(1) + b"\x00")  # extra data
    with pytest.raises(TypeError):
        _msgpack.packb({"x": object()})
    with pytest.raises(OverflowError):
        _msgpack.packb(2**64)


# ------------------------------------------------------------ file format
def _np_tree():
    """Leaves of every dtype the formats carry, in dicts whose keys were
    inserted unsorted (the flatten order must sort them, as JAX's does)."""
    rng = np.random.default_rng(0)
    bf16 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "zeta": {"w": bf16, "b10": rng.integers(0, 255, 7, dtype=np.uint8),
                 "b2": rng.standard_normal(4).astype(np.float32)},
        "alpha": [rng.integers(-9, 9, (2, 2), dtype=np.int32),
                  (rng.standard_normal((1, 3)).astype(np.float32),)],
        "mid": rng.standard_normal(()).astype(np.float32),
    }


def _jax_tree(tree):
    out = {k: v for k, v in tree.items()}
    out["zeta"] = dict(tree["zeta"], w=jnp.asarray(tree["zeta"]["w"],
                                                   jnp.bfloat16))
    return out


def _torch_tree(tree):
    def t(x):
        return torch.from_numpy(np.array(x))

    return {
        "zeta": {"w": t(tree["zeta"]["w"]).to(torch.bfloat16),
                 "b10": t(tree["zeta"]["b10"]), "b2": t(tree["zeta"]["b2"])},
        "alpha": [t(tree["alpha"][0]), (t(tree["alpha"][1][0]),)],
        "mid": t(tree["mid"]),
    }


def _bits(x):
    """Leaf bits as a numpy array: bf16 (either package) as uint16."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def _same_tree(a, b):
    la = [_bits(x) for x in _flat(a)]
    lb = [_bits(x) for x in _flat(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _flat(tree):
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


@pytest.fixture(params=["zstd", "zlib"])
def codec(request, monkeypatch):
    if request.param == "zlib":
        monkeypatch.setattr(jckpt_mod, "zstandard", None)
        monkeypatch.setattr(tckpt_mod, "zstandard", None)
    else:
        assert tckpt_mod.zstandard is not None and jckpt_mod.zstandard
    return request.param


def test_files_cross_between_packages(tmp_path, codec):
    tree = _np_tree()
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jckpt.save(jpath, _jax_tree(tree), step=7)
    tckpt.save(tpath, _torch_tree(tree), step=7)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        jblob, tblob = f.read(), g.read()
    assert jblob == tblob
    assert (jblob[:4] == b"\x28\xb5\x2f\xfd") == (codec == "zstd")
    # JAX-written → port, and port-written → JAX
    got, step = tckpt.restore(jpath, _torch_tree(tree))
    assert step == 7
    assert got["zeta"]["w"].dtype == torch.bfloat16
    assert isinstance(got["alpha"][1], tuple)
    _same_tree(got, _torch_tree(tree))
    back, step = jckpt.restore(tpath, _jax_tree(tree))
    assert step == 7 and back["zeta"]["w"].dtype == jnp.bfloat16
    _same_tree(back, _jax_tree(tree))


def test_restore_places_leaves(tmp_path):
    path = str(tmp_path / "p.ckpt")
    tckpt.save(path, _torch_tree(_np_tree()))
    like = {"zeta": {"w": 0, "b10": 0, "b2": 0}, "alpha": [0, (0,)],
            "mid": 0}
    got, _ = tckpt.restore(path, like, device="cpu")
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in _flat(got))


def test_wrong_leaf_count_raises_as_reference(tmp_path):
    path = str(tmp_path / "m.ckpt")
    tckpt.save(path, {"a": torch.zeros(2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore(path, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        jckpt.restore(path, {"a": jnp.zeros(2)})


def test_restore_leaves_and_latest_step_path(tmp_path):
    d = str(tmp_path / "r0")
    assert tckpt.latest_step_path(d) is None
    manifest = np.frombuffer(_msgpack.packb(_manifest()), np.uint8)
    pages = [np.full(6, i, np.float32) for i in range(3)]
    for step in (16, 32, 8):
        jckpt.save(os.path.join(d, f"ckpt_{step}.ckpt"),
                   [manifest] + pages, step=step)
    open(os.path.join(d, "ckpt_x.ckpt"), "wb").close()  # not a step
    path = tckpt.latest_step_path(d)
    assert path == jckpt.latest_step_path(d) == os.path.join(d,
                                                             "ckpt_32.ckpt")
    leaves, step = tckpt.restore_leaves(path)
    jleaves, jstep = jckpt.restore_leaves(path)
    assert step == jstep == 32 and len(leaves) == len(jleaves) == 4
    assert _msgpack.unpackb(leaves[0].tobytes()) == _manifest()
    for a, b in zip(leaves, jleaves):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_async_checkpointer_snapshots_and_surfaces_errors(tmp_path):
    ck = tckpt.AsyncCheckpointer()
    x = torch.arange(6, dtype=torch.float32)
    path = str(tmp_path / "a" / "ckpt_1.ckpt")
    ck.save(path, {"x": x}, step=1)
    x += 100.0  # the save snapshotted before returning
    ck.wait()
    got, step = tckpt.restore(path, {"x": x})
    assert step == 1 and got["x"].tolist() == list(range(6))
    blocker = tmp_path / "file"
    blocker.write_bytes(b"")
    ck.save(str(blocker / "ckpt_2.ckpt"), {"x": x}, step=2)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error is reported once


# ------------------------------------------------------------------- fault
def test_straggler_detector_equals_reference():
    rng = np.random.default_rng(3)
    jd = jfault.StragglerDetector(min_samples=4, ratio=1.5, window=8)
    td = tfault.StragglerDetector(min_samples=4, ratio=1.5, window=8)
    flagged = 0
    for step in range(60):
        host = f"r{int(rng.integers(0, 4))}"
        t = float(rng.uniform(0.5, 1.5)) * (6.0 if host == "r2" else 1.0)
        jd.observe(host, t)
        td.observe(host, t)
        assert td.stragglers() == jd.stragglers()
        assert td.rebalance_weights() == jd.rebalance_weights()
        flagged += td.stragglers() == ["r2"]
        if step == 40:
            jd.forget("r2")
            td.forget("r2")
            assert td.stragglers() == jd.stragglers() == []
    assert flagged > 0


def test_restart_manager_equals_reference(tmp_path):
    kw = dict(max_retries=4, backoff_s=1.5, max_backoff_s=5.0)
    jm = jfault.RestartManager(str(tmp_path), **kw)
    tm = tfault.RestartManager(str(tmp_path), **kw)
    for _ in range(6):
        assert tm.should_retry() == jm.should_retry()
        assert tm.on_failure(RuntimeError("x")) == jm.on_failure(
            RuntimeError("x"))
    tm.on_success()
    assert tm.failures == 0 and tm.should_retry()
    with pytest.raises(ValueError):
        tfault.RestartManager("", backoff_s=2.0, max_backoff_s=1.0)
    like = {"w": torch.zeros(3, dtype=torch.bfloat16), "n": torch.zeros(2)}
    assert tm.resume(like) == (None, 0)
    jckpt.save(str(tmp_path / "ckpt_5.ckpt"),
               {"w": jnp.asarray([1.0, 2.0, 3.0], jnp.bfloat16),
                "n": np.arange(2, dtype=np.float32)}, step=5)
    tree, step = tm.resume(like)
    assert step == 5 and tree["w"].dtype == torch.bfloat16
    assert tree["w"].float().tolist() == [1.0, 2.0, 3.0]


def test_tree_helpers_leave_no_reference_cycle():
    """Flattening and rebuilding keep no leaf alive: a recursive closure
    would hold every leaf in a reference cycle until the cycle collector
    ran — the weights of a whole model, at full width, for ``init_model``
    and the engine's cache walks."""
    import gc
    import weakref

    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    gc.disable()
    try:
        t = torch.zeros(4)
        alive = weakref.ref(t)
        tree = {"b": [t, None], "a": (torch.ones(2),)}
        leaves, treedef = tree_flatten(tree)
        back = tree_unflatten(treedef, leaves)
        assert back["b"][0] is t and back["b"][1] is None
        assert tree_leaves(tree)[1] is t  # keys sorted: "a" first
        del t, tree, leaves, back
        assert alive() is None
    finally:
        gc.enable()


# ------------------------------------------------------------ training state
def test_tree_round_trips_a_namedtuple():
    """``tree`` treats a NamedTuple as ``jax.tree_util`` does: its fields
    in order as children, rebuilt with ``type(x)(*children)``."""
    import jax

    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    m = {"b": np.arange(3.0), "a": [np.ones(2)]}
    v = {"b": np.arange(3.0) * 2, "a": [np.ones(2) * 3]}
    state = tadamw.AdamWState(np.int32(4), m, v)
    leaves, treedef = tree_flatten(state)
    want = jax.tree_util.tree_leaves(jadamw.AdamWState(np.int32(4), m, v))
    assert len(leaves) == len(want) == 5
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(a, b)
    back = tree_unflatten(treedef, leaves)
    assert isinstance(back, tadamw.AdamWState) and back.step == 4
    doubled = tree_map(lambda x: x * 2, state)
    assert isinstance(doubled, tadamw.AdamWState)
    np.testing.assert_array_equal(doubled.v["a"][0], [6.0, 6.0])


def _train_state(seed):
    """(params with bf16 and f32 leaves, AdamWState at step 3) as numpy."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
              "layers": {"b1": rng.standard_normal((2, 5)).astype(
                  ml_dtypes.bfloat16), "b0": rng.standard_normal(
                  (2, 5)).astype(np.float32)}}
    m = {k: v for k, v in (("w", rng.standard_normal((4, 3)).astype(
        np.float32)), ("layers", {"b1": np.ones((2, 5), np.float32),
                                  "b0": np.zeros((2, 5), np.float32)}))}
    v = {"w": np.abs(m["w"]), "layers": {"b1": np.full((2, 5), 2.0,
                                                       np.float32),
                                         "b0": np.ones((2, 5), np.float32)}}
    return params, np.int32(3), m, v


def test_training_state_crosses_between_packages(tmp_path, codec):
    """A (params, AdamWState) checkpoint — the trainers' — written by the
    port restores under ``repro.checkpoint`` with equal leaves and an
    ``AdamWState``, and the JAX package's restores in the port the same
    way; the two files are the same bytes."""
    import jax

    from repro.optim import adamw as jadamw
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw as tadamw

    params, step, m, v = _train_state(11)
    jstate = (jax.tree_util.tree_map(jnp.asarray, params),
              jadamw.AdamWState(jnp.int32(step), m, v))
    tparams = params_from_numpy(params, "cpu")
    tstate = (tparams, tadamw.AdamWState(
        torch.tensor(step, dtype=torch.int32), params_from_numpy(m, "cpu"),
        params_from_numpy(v, "cpu")))
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jckpt.save(jpath, jstate, step=3)
    tckpt.save(tpath, tstate, step=3)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    back, s = jckpt.restore(tpath, jstate)
    assert s == 3 and isinstance(back[1], jadamw.AdamWState)
    assert back[0]["w"].dtype == jnp.bfloat16 and back[1].step == 3
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got, s = tckpt.restore(jpath, tstate)
    assert s == 3 and isinstance(got[1], tadamw.AdamWState)
    assert got[1].step.dtype == torch.int32 and int(got[1].step) == 3
    for a, b in zip(_flat(got), _flat(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_stored_zlib_file_restores_in_the_jax_package(tmp_path,
                                                         monkeypatch):
    """``ZLIB_LEVEL = 0`` (stored blocks: a full-width training state
    written in seconds) is still the JAX package's file format."""
    monkeypatch.setattr(tckpt_mod, "zstandard", None)
    monkeypatch.setattr(tckpt_mod, "ZLIB_LEVEL", 0)
    tree = _np_tree()
    path = str(tmp_path / "s.ckpt")
    ck = tckpt.AsyncCheckpointer()
    ck.save(path, _torch_tree(tree), step=5)
    ck.wait()
    back, step = jckpt.restore(path, _jax_tree(tree))
    assert step == 5
    _same_tree(back, _jax_tree(tree))
