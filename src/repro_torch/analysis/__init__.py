"""Report/CLI layer over :mod:`repro_torch.core.analysis`.

``repro_torch.core.analysis`` holds the verification engine (pure, importable
from the serving stack); this package holds everything user-facing: batch
runs over the grammar zoo, text/JSON rendering, and the ``python -m
repro_torch.analyze`` entry point the CI gate calls.
"""
from repro_torch.core.analysis import (AnalysisError, AnalysisReport,
                                 ClosureCertificate, Issue, POLICIES,
                                 Witness, analyze, enforce)
from repro_torch.analysis.report import bytes_vocab, run_batch, write_json

__all__ = [
    "AnalysisError", "AnalysisReport", "ClosureCertificate", "Issue",
    "POLICIES", "Witness", "analyze", "enforce",
    "bytes_vocab", "run_batch", "write_json",
]
