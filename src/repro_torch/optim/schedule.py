"""Learning-rate schedules (step tensor -> lr tensor); port of
``repro/optim/schedule.py``."""
import math

import torch


def constant(lr):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_decay(lr, total_steps, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.float(), max=total_steps) / total_steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr, warmup_steps, total_steps, final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        warm = lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn
