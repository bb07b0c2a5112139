"""Trainer: the fault-tolerant training loop, as the JAX package's
``repro.train.trainer``.

Composes: data pipeline → train step (remat + microbatching + optional
int8-EF gradient compression) → async checkpointing → straggler
detection → restart-from-latest.  The loop is crash-safe: any exception
inside a step falls back to the RestartManager policy (restore latest
checkpoint, bounded retries with backoff).  It runs on ``device``
(``"cuda"`` unless asked otherwise); where JAX blocks on the step's
loss, the port synchronises the card.  Checkpoints are the JAX
package's files of ``(params, AdamWState)``: either package resumes the
other's.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint.checkpointing import AsyncCheckpointer
from ..configs.base import ArchConfig, ShapeConfig
from ..data.pipeline import PROCESS_INDEX, DataConfig, DataPipeline
from ..dist import compression
from ..dist.fault import RestartManager, StragglerDetector
from ..models import init_model
from ..models.transformer import resolve_device
from ..optim import adamw
from .train_step import make_train_step, pin_batch, value_and_grad


@dataclass
class TrainerConfig:
    steps: int = 20
    #: under the temporary directory (``TMPDIR``); a run resumes from the
    #: newest checkpoint here
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 10
    microbatches: int = 1
    remat: bool = True
    grad_compression: bool = False
    seed: int = 0
    log_every: int = 5
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    #: MURS-adaptive accumulation: a probe returning the device pool's
    #: used fraction drives the microbatch factor through the yellow/red
    #: thresholds (repro_torch.train.pressure).  None disables.
    hbm_probe: Optional[Callable[[], float]] = None
    #: where the model trains: the card unless asked otherwise
    device: str = "cuda"


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeConfig,
        tcfg: Optional[TrainerConfig] = None,
        *,
        batch: Optional[int] = None,
        seq: Optional[int] = None,
    ) -> None:
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg or TrainerConfig()
        self.batch = batch
        self.seq = seq
        self.device = resolve_device(self.tcfg.device)
        self.ckpt = AsyncCheckpointer()
        self.restart = RestartManager(self.tcfg.ckpt_dir)
        self.straggler = StragglerDetector()
        self.metrics_log: list = []
        #: wire size of one compressed gradient exchange (grad_compression)
        self.compressed_wire_bytes: Optional[int] = None
        self._adaptive = None
        self._step_cache: Dict[int, Any] = {}
        if self.tcfg.hbm_probe is not None:
            from .pressure import PressureAdaptiveAccumulator

            global_batch = batch if batch is not None else shape.global_batch
            self._adaptive = PressureAdaptiveAccumulator(
                probe=self.tcfg.hbm_probe,
                # the factor slices the batch: never exceed it (keep it a
                # power of two ≤ batch so slices stay equal-sized)
                max_factor=1 << (max(global_batch, 1).bit_length() - 1),
            )
            self._adaptive.factor = max(self.tcfg.microbatches, 1)

    # ----------------------------------------------------------- build/run
    def init_params(self):
        """Random parameters from the seed, on the trainer's device."""
        return init_model(self.cfg, self.tcfg.seed, device=self.device)

    def build(self):
        params = self.init_params()
        opt_state = adamw.init(params)
        step_fn = make_train_step(
            self.cfg,
            self.tcfg.opt,
            microbatches=self.tcfg.microbatches,
            remat=self.tcfg.remat,
        )
        if self.tcfg.grad_compression:
            # grads → EF-int8 → optimizer, one microbatch, as the JAX
            # package's compressed step
            def step_with_compression(params, opt_state, ef, batch):
                batch = pin_batch(batch)  # as make_train_step pins it
                loss, grads = value_and_grad(self.cfg, params, batch,
                                             remat=self.tcfg.remat)
                grads, ef, cerr = compression.compress_grads(grads, ef)
                new_p, new_o, gnorm = adamw.update(
                    self.tcfg.opt, grads, opt_state, params
                )
                return new_p, new_o, ef, {
                    "loss": loss,
                    "grad_norm": gnorm,
                    "compression_err": cerr,
                    "step": new_o.step,
                }

            self._step = step_with_compression
            self._ef = compression.init(params)
            self.compressed_wire_bytes = compression.compressed_bytes(params)
        else:
            self._step = step_fn
            self._ef = None
        return params, opt_state

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict[str, Any]:
        params, opt_state = self.build()
        # resume-from-latest (fault tolerance)
        restored, start_step = self.restart.resume((params, opt_state))
        if restored is not None:
            params, opt_state = restored
        pipeline = DataPipeline(
            self.cfg, self.shape, DataConfig(seed=self.tcfg.seed),
            batch=self.batch, seq=self.seq, device=self.device,
        )
        host = f"host{PROCESS_INDEX}"
        step = start_step
        try:
            while step < self.tcfg.steps:
                batch = next(pipeline)
                t0 = time.monotonic()
                # MURS-adaptive accumulation: a step per factor
                if self._adaptive is not None and self._ef is None:
                    factor = self._adaptive.step()
                    if factor not in self._step_cache:
                        self._step_cache[factor] = make_train_step(
                            self.cfg, self.tcfg.opt,
                            microbatches=factor, remat=self.tcfg.remat,
                        )
                    self._step = self._step_cache[factor]
                try:
                    if self._ef is not None:
                        params, opt_state, self._ef, metrics = self._step(
                            params, opt_state, self._ef, batch
                        )
                    else:
                        params, opt_state, metrics = self._step(
                            params, opt_state, batch
                        )
                    self._sync()
                    self.restart.on_success()
                except Exception as exc:  # crash/preempt → restore + retry
                    if not self.restart.should_retry():
                        raise
                    time.sleep(min(self.restart.on_failure(exc), 0.1))
                    restored, step = self.restart.resume((params, opt_state))
                    if restored is not None:
                        params, opt_state = restored
                    continue
                dt = time.monotonic() - t0
                self.straggler.observe(host, dt)
                step += 1
                if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                    self.metrics_log.append(
                        {
                            "step": step,
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "step_time_s": dt,
                            "stragglers": self.straggler.stragglers(),
                        }
                    )
                if step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(
                        f"{self.tcfg.ckpt_dir}/ckpt_{step}.ckpt",
                        (params, opt_state),
                        step=step,
                    )
                    self.restart.record_heartbeat(step)
        finally:
            pipeline.close()
            self.ckpt.wait()
        return {
            "final_step": step,
            "final_loss": (self.metrics_log[-1]["loss"] if self.metrics_log
                           else None),
            "log": self.metrics_log,
        }
