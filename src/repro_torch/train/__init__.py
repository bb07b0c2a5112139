from .train_step import lm_loss, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["lm_loss", "make_train_step", "Trainer", "TrainerConfig"]
