"""Synthetic-token data pipeline with background prefetch, as the JAX
package's ``repro.data.pipeline``.

Every batch is made on the host with numpy, deterministically from
(seed, step, process index): the same arrays as the JAX package's, bit
for bit (one process here, so the process index is 0).  A background
thread keeps ``prefetch`` batches ahead of the training loop, in pinned
host memory when they go to a card; ``next()`` copies them to the
caller's device without waiting for the copy.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig

#: this process's index among the job's (one process on one card)
PROCESS_INDEX = 0


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    prefetch: int = 2
    pad_fraction: float = 0.0  # fraction of tail positions padded (label −1)


def _host_batch(
    cfg: ArchConfig,
    shape: ShapeConfig,
    data_cfg: DataConfig,
    step: int,
    *,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Deterministic synthetic batch for this host (numpy): the JAX
    package's, bit for bit."""
    b = batch if batch is not None else shape.global_batch
    s = seq if seq is not None else shape.seq_len
    rng = np.random.default_rng(
        (data_cfg.seed * 1_000_003 + step) * 97 + PROCESS_INDEX
    )
    tokens = rng.integers(0, cfg.vocab, size=(b, s), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    if data_cfg.pad_fraction > 0.0:
        pad = int(s * data_cfg.pad_fraction)
        if pad:
            labels[:, -pad:] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model), dtype=np.float32
        )
    if cfg.enc_layers:
        t_enc = s // cfg.enc_seq_divisor
        out["frame_embeds"] = rng.standard_normal(
            (b, t_enc, cfg.d_model), dtype=np.float32
        )
    return out


class DataPipeline:
    """Iterator of device batches with background prefetch."""

    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeConfig,
        data_cfg: Optional[DataConfig] = None,
        *,
        batch: Optional[int] = None,
        seq: Optional[int] = None,
        device: Union[str, torch.device] = "cpu",
    ) -> None:
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg or DataConfig()
        self.batch = batch
        self.seq = seq
        self.device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.data_cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _produce_one(self, step: int) -> Dict[str, torch.Tensor]:
        host = _host_batch(
            self.cfg, self.shape, self.data_cfg, step,
            batch=self.batch, seq=self.seq,
        )
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t
        return out

    def _producer(self) -> None:
        step = 0
        while not self._stop.is_set():
            try:
                self._q.put(self._produce_one(step), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        host = self._q.get()
        return {k: v.to(self.device, non_blocking=True)
                for k, v in host.items()}

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
