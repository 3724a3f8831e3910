"""Observability (counterpart of the JAX package's `obs/`): the JSONL
logger, torch.profiler traces and their reader (`obs.trace_summary`), the
step timer, the training dashboards and the latent-space analysis
(`obs.analysis`)."""
from .logger import Experiment, JsonlLogger, NullLogger
from .profile import profile_trace, StepTimer
from .dashboard import TrainingDashboard, FaderDashboard, moving_average

__all__ = ["Experiment", "JsonlLogger", "NullLogger", "profile_trace",
           "StepTimer", "TrainingDashboard", "FaderDashboard",
           "moving_average"]
