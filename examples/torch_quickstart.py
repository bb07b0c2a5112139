"""Quickstart on the PyTorch port: build a tiny model, train it,
checkpoint, resume — ``examples/quickstart.py`` through ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py                # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # no card

``--device cuda`` (the default) fails where there is no card.
"""

import argparse
import tempfile

from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails where there is no card")
    args = ap.parse_args()

    cfg = ARCHS["internlm2-1.8b"].smoke()  # reduced same-family config
    shape = ShapeConfig("quickstart", seq_len=64, global_batch=8, kind="train")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg, shape,
            TrainerConfig(
                steps=20, ckpt_dir=ckpt_dir, ckpt_every=10, log_every=5,
                opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20),
                device=args.device,
            ),
        )
        out = trainer.run()
        print("trained to step", out["final_step"])
        for m in out["log"]:
            print(f"  step {m['step']:3d}  loss {m['loss']:.4f}  "
                  f"{m['step_time_s'] * 1e3:.0f} ms/step")
        # crash-recovery demo: a fresh trainer resumes from the checkpoint
        resumed = Trainer(
            cfg, shape,
            TrainerConfig(
                steps=25, ckpt_dir=ckpt_dir, ckpt_every=10, log_every=5,
                opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=25),
                device=args.device,
            ),
        )
        out2 = resumed.run()
        print("resumed from ckpt →", out2["final_step"])


if __name__ == "__main__":
    main()
