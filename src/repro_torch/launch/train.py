"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-tolerant Trainer on the selected architecture, with the
flags of the JAX package's ``repro.launch.train``: the reduced (smoke)
config by default, ``--full`` for the full one; runs on the card unless
``--device cpu``.  Every architecture trains on the card, the Mamba-2
models (mamba2, zamba2) through the SSD scan kernel K6 and its
hand-written backward.
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--full", action="store_true",
                    help="use the full config (a card's memory)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train"),
                    help="checkpoints; a run resumes from the newest here")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails where there is no card")
    args = ap.parse_args()

    # full-precision f32 matmuls: no TF32 anywhere in the port
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.smoke()
    shape = SHAPES[args.shape]
    batch = args.batch if args.batch else (None if args.full else 4)
    seq = args.seq if args.seq else (None if args.full else 64)
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps")
    trainer = Trainer(
        cfg, shape,
        TrainerConfig(
            steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            microbatches=args.microbatches,
            grad_compression=args.grad_compression,
            opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps),
            device=args.device,
        ),
        batch=batch,
        seq=seq,
    )
    out = trainer.run()
    if trainer.compressed_wire_bytes is not None:
        print(f"grad compression: {trainer.compressed_wire_bytes / 1e6:.2f} "
              f"MB/exchange (f32 would be {4 * cfg.param_count() / 1e6:.2f} "
              "MB)")
    print(f"finished at step {out['final_step']}  loss={out['final_loss']}")
    for m in out["log"][-3:]:
        print(f"  step {m['step']}  loss {m['loss']:.4f}  "
              f"{m['step_time_s'] * 1e3:.0f} ms")


if __name__ == "__main__":
    main()
