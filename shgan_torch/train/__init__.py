from .loss import d_main_loss, d_r1_loss, g_main_loss, g_pl_loss, run_g
from .schedules import get_optimizer, get_scheduler
from .step import (TrainConfig, TrainStep, compute_ema_beta, ema_update,
                   freeze_buffers, make_optimizer, nan_scrub, optimizer_step)
