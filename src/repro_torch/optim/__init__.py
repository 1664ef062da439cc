from repro_torch.optim.optimizers import Optimizer, adafactor, adam, adamw, sgd
from repro_torch.optim.schedule import constant, cosine_decay, warmup_cosine

__all__ = ["Optimizer", "sgd", "adam", "adamw", "adafactor",
           "constant", "cosine_decay", "warmup_cosine"]
