"""Runtime of the port (port of `repro.runtime`): the fault-tolerant
training loop, its heartbeat/straggler monitor and the adaptive scrub
controller."""
from .adaptive import AdaptiveScrub, AdaptiveScrubConfig
from .loop import LoopConfig, TrainLoop
from .monitor import Decision, HeartbeatMonitor, StragglerPolicy

__all__ = ["AdaptiveScrub", "AdaptiveScrubConfig", "LoopConfig", "TrainLoop",
           "HeartbeatMonitor", "StragglerPolicy", "Decision"]
