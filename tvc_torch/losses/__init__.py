from tvc_torch.losses.dsm import anneal_dsm_score_estimation, draw_dsm
from tvc_torch.losses.ema import EMAHelper, ema_update
from tvc_torch.losses.optimizers import Optimizer, get_optimizer, warmup_schedule

__all__ = [
    "anneal_dsm_score_estimation",
    "draw_dsm",
    "EMAHelper",
    "ema_update",
    "Optimizer",
    "get_optimizer",
    "warmup_schedule",
]
