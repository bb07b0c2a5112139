"""Checkpointing: atomic, compressed, async-capable.

Format: one ``<name>.ckpt`` file containing a compressed MessagePack map
  { "meta": {step, n_leaves}, "leaves": [ {dtype, shape, data} ] }
compressed with zstd when the ``zstandard`` package is available, zlib
otherwise; the codec is detected from the frame magic on restore, so a
file written with either codec restores wherever that codec can be read.
The format is the JAX package's (``repro.checkpoint``), byte for byte:
leaves are flattened in ``jax.tree_util`` order (:mod:`repro_torch.tree`),
``bfloat16`` leaves travel as a ``uint16`` view, and the container is
packed by the port's own MessagePack codec
(:mod:`repro_torch.checkpoint._msgpack`), so files cross between the two
packages in both directions.

Restore reads leaves host-side and places them on the device the caller
names (or where the ``like`` tree's tensors live).  Writes are atomic
(tmp + rename) and optionally asynchronous (snapshot to host first, a
background thread serializes), so a caller never blocks on disk.

A zlib file is written and read as a stream, one leaf at a time: the
same bytes as compressing the whole container at once, without a
second copy of it in host memory (a full-width training state is tens
of GB).  Its level is :data:`ZLIB_LEVEL`.
"""

from __future__ import annotations

import os
import tempfile
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

try:
    import zstandard
except ImportError:  # hermetic containers: fall back to stdlib zlib
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


#: zlib's level where ``zstandard`` is absent (the JAX package's 6); read
#: at each write, so a process may set it (0 stores a file without
#: compressing it, in the same format)
ZLIB_LEVEL = 6


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                "checkpoint is zstd-compressed but zstandard is not installed"
            )
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


PyTree = Any


class _Bf16:
    """A bfloat16 leaf on the host: numpy has no bfloat16, so its bits
    travel as a uint16 array (the JAX package's file format too)."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray) -> None:
        self.bits = bits


def _host_leaf(x: Any) -> Any:
    """One leaf on the host: a torch tensor becomes a numpy array (a
    bfloat16 one a :class:`_Bf16`); anything else goes through
    ``np.asarray``."""
    if isinstance(x, _Bf16):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)  # a snapshot, not a view
        if x.dtype == torch.bfloat16:
            return _Bf16(x.view(torch.uint16).numpy())
        return x.numpy()
    return np.asarray(x)


def _unpack_leaf(d: dict) -> Any:
    """A leaf as the file holds it: a numpy array, or a :class:`_Bf16`."""
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], dtype=np.uint16).reshape(d["shape"])
        return _Bf16(raw)
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]
    )


def _to_tensor(leaf: Any, device: Any) -> torch.Tensor:
    if isinstance(leaf, _Bf16):
        return torch.from_numpy(leaf.bits.copy()).view(torch.bfloat16).to(
            device
        )
    return torch.from_numpy(leaf.copy()).to(device)


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        if f.read(4) == _ZSTD_MAGIC:
            f.seek(0)
            return _msgpack.unpackb(_decompress(f.read()))
        f.seek(0)
        inflate = zlib.decompressobj()
        raw = bytearray()
        while True:
            chunk = f.read(1 << 26)
            if not chunk:
                break
            raw += inflate.decompress(chunk)
        raw += inflate.flush()
    return _msgpack.unpackb(raw)


def _container(leaves: list, step: int):
    """The file's MessagePack container in pieces whose concatenation is
    ``packb({"meta": {step, n_leaves}, "leaves": [{dtype, shape, data},
    ...]})`` (a bfloat16 leaf's data its ``uint16`` bits): the head, then
    per leaf its map's header bytes and its data as a buffer (not
    copied)."""
    yield (_msgpack.header("map", 2) + _msgpack.packb("meta")
           + _msgpack.packb({"step": step, "n_leaves": len(leaves)})
           + _msgpack.packb("leaves") + _msgpack.header("array", len(leaves)))
    for leaf in leaves:
        arr = leaf.bits if isinstance(leaf, _Bf16) else leaf
        dtype = "bfloat16" if isinstance(leaf, _Bf16) else str(leaf.dtype)
        data = memoryview(np.ascontiguousarray(arr)).cast("B")
        yield (_msgpack.header("map", 3)
               + _msgpack.packb("dtype") + _msgpack.packb(dtype)
               + _msgpack.packb("shape") + _msgpack.packb(list(arr.shape))
               + _msgpack.packb("data") + _msgpack.header("bin", len(data)))
        yield data


def save(path: str, tree: PyTree, *, step: int = 0) -> None:
    """Atomic synchronous save."""
    leaves = [_host_leaf(x) for x in tree_flatten(tree)[0]]
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            if zstandard is not None:
                f.write(zstandard.ZstdCompressor(level=3).compress(
                    b"".join(_container(leaves, step))))
            else:
                deflate = zlib.compressobj(ZLIB_LEVEL)
                for piece in _container(leaves, step):
                    f.write(deflate.compress(piece))
                f.write(deflate.flush())
        os.replace(tmp, path)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore(
    path: str,
    like: PyTree,
    *,
    device: Optional[Any] = None,
) -> tuple[PyTree, int]:
    """Restore into the structure of ``like``.  Returns (tree, step).

    Leaves come back as torch tensors in the file's dtypes (bfloat16
    where the file says so), on ``device`` when given, else on the
    device of ``like``'s tensor at the same place (the CPU where that
    leaf is not a tensor).  ``like``'s leaves only mark places: they may
    be tensors, arrays or any placeholder.
    """
    payload = _read(path)
    like_leaves, treedef = tree_flatten(like)
    leaves = [_unpack_leaf(d) for d in payload["leaves"]]
    if len(leaves) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, target needs "
            f"{len(like_leaves)} — structure mismatch"
        )
    out = []
    for leaf, ref in zip(leaves, like_leaves):
        where = device
        if where is None:
            where = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        out.append(_to_tensor(leaf, where))
    return tree_unflatten(treedef, out), payload["meta"]["step"]


def restore_leaves(path: str) -> tuple[list, int]:
    """Restore a checkpoint's raw leaf LIST without a ``like`` tree.

    For self-describing checkpoints — trees saved as a flat list whose
    first leaf is its own manifest (the serving cluster's KV snapshots:
    ``repro_torch.serve.cluster.ServingCluster`` packs a MessagePack
    manifest leaf followed by one array per checkpointed page) — no
    target structure exists before the file is read, so
    :func:`restore`'s structure check is a chicken-and-egg.  Returns
    ``(leaves, step)`` host-side as numpy arrays (a bfloat16 leaf as its
    ``uint16`` bits); the caller interprets the leaves.
    """
    payload = _read(path)
    leaves = [_unpack_leaf(d) for d in payload["leaves"]]
    leaves = [l.bits if isinstance(l, _Bf16) else l for l in leaves]
    return leaves, payload["meta"]["step"]


class AsyncCheckpointer:
    """Snapshot-then-serialize-in-background checkpointer.

    ``save`` snapshots device tensors to host (blocking only for the D2H
    copy), then a worker thread compresses and writes.  ``wait`` joins
    the in-flight write (call before exiting or before depending on the
    file).
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, tree: PyTree, *, step: int = 0) -> None:
        """Snapshot to host synchronously, then write on a background
        thread; a previous in-flight save is awaited first."""
        self.wait()
        host = tree_map(_host_leaf, tree)  # synchronous D2H snapshot

        def work():
            try:
                save(path, host, step=step)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save (if any) finishes; re-raises
        any error the writer thread hit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step_path(directory: str, prefix: str = "ckpt") -> Optional[str]:
    """Find the newest ``<prefix>_<step>.ckpt`` in ``directory``."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix + "_") and name.endswith(".ckpt"):
            try:
                s = int(name[len(prefix) + 1 : -5])
            except ValueError:
                continue
            if s > best_step:
                best, best_step = os.path.join(directory, name), s
    return best
