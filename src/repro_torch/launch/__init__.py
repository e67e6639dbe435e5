from .engine import GenerationEngine, fetch_telemetry

__all__ = ["GenerationEngine", "fetch_telemetry"]
