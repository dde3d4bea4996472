from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.faults import (FaultInjector, InjectedFault,
                                        InvariantViolation, check_invariants)
from repro_torch.serving.journal import (JournalEntry, TokenJournal,
                                         read_records, replay_journal)
from repro_torch.serving.prefix_cache import PrefixCache, RadixNode
from repro_torch.serving.request import ConstraintSpec, DecodeParams, Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.serving.session import GenerationResult, Session
from repro_torch.serving.supervisor import DegradationSupervisor

__all__ = ["ServingEngine", "EngineConfig", "GenerationResult", "Session",
           "ContinuousBatchingScheduler", "ConstraintSpec", "DecodeParams",
           "Request", "FaultInjector", "InjectedFault",
           "InvariantViolation", "check_invariants", "TokenJournal",
           "JournalEntry", "read_records", "replay_journal",
           "DegradationSupervisor", "PrefixCache", "RadixNode"]
