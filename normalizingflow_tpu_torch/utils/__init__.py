from .profiling import StepTimer, annotate, debug_mode, trace

__all__ = ["StepTimer", "annotate", "debug_mode", "trace"]
