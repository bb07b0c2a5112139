"""End-to-end training driver on the PyTorch port: a ~100M-parameter LM,
a few hundred steps — ``examples/train_lm.py`` through ``repro_torch``.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300   # full run
    PYTHONPATH=src python examples/torch_train_lm.py --steps 10    # smoke
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 2 \\
        --batch 2 --seq 32                                          # no card

Features exercised: synthetic data pipeline with prefetch, remat,
microbatch gradient accumulation, int8 error-feedback gradient compression,
async checkpointing, straggler telemetry, crash-resume: a run resumes
from the newest checkpoint in ``--ckpt-dir``.  ``--device cuda`` (the
default) fails where there is no card.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def build_100m():
    """~110 M params: a scaled-down internlm2-family decoder."""
    base = ARCHS["internlm2-1.8b"]
    return dataclasses.replace(
        base,
        name="lm-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2048,
        vocab=32_000,
        d_head=64,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_lm100m"))
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails where there is no card")
    args = ap.parse_args()

    cfg = build_100m()
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M")
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    trainer = Trainer(
        cfg, shape,
        TrainerConfig(
            steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=50,
            log_every=10,
            grad_compression=args.grad_compression,
            opt=AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
            device=args.device,
        ),
    )
    out = trainer.run()
    if not out["log"]:  # resumed at or past --steps: nothing ran
        print(f"done: step {out['final_step']}  (nothing to train)")
        return
    first = out["log"][0]
    print(f"first logged: step {first['step']}  loss {first['loss']:.4f}")
    print(f"done: step {out['final_step']}  final loss {out['final_loss']:.4f}")
    for m in out["log"][-5:]:
        print(f"  step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"{m['step_time_s'] * 1e3:.0f} ms/step  "
              f"stragglers={m['stragglers']}")


if __name__ == "__main__":
    main()
