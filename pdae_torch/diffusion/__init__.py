from . import ddim
from .gaussian import GaussianDiffusion
from .schedules import (DDIMSchedule, Schedule, extract, make_betas,
                        make_ddim_schedule, make_schedule, respace)

__all__ = ["ddim", "GaussianDiffusion", "DDIMSchedule", "Schedule", "extract",
           "make_betas", "make_ddim_schedule", "make_schedule", "respace"]
