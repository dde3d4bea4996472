from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import ConstraintSpec, DecodeParams, Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.serving.session import GenerationResult, Session

__all__ = ["ServingEngine", "EngineConfig", "GenerationResult", "Session",
           "ContinuousBatchingScheduler", "ConstraintSpec", "DecodeParams",
           "Request"]
