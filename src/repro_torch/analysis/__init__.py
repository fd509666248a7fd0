"""Static network analysis for the port: the numpy validator
(`repro_torch.analysis.validate`) that `compile_spec(validate=True)`
runs over every artifact."""
from repro_torch.analysis.validate import (AnalysisError, AnalysisReport,
                                           Finding, validate_compiled,
                                           validate_spec)

__all__ = ["AnalysisError", "AnalysisReport", "Finding",
           "validate_compiled", "validate_spec"]
