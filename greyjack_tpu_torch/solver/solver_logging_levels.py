"""Logging levels. Reference: `greyjack/src/solver/solver_logging_levels.rs:2-8`."""

import enum


class SolverLoggingLevels(enum.Enum):
    Info = "Info"
    FreshOnly = "FreshOnly"
    Trace = "Trace"
    Warn = "Warn"
    Silent = "Silent"
