from . import ddim, dpm_solver
from .dpm_solver import SolverTables, make_solver_tables
from .gaussian import GaussianDiffusion
from .schedules import (DDIMSchedule, Schedule, extract, make_betas,
                        make_ddim_schedule, make_schedule, respace)

__all__ = ["ddim", "dpm_solver", "GaussianDiffusion", "DDIMSchedule", "Schedule",
           "SolverTables", "extract", "make_betas", "make_ddim_schedule",
           "make_schedule", "make_solver_tables", "respace"]
