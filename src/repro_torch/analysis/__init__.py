"""Static network analysis for the port: the numpy validator
(`repro_torch.analysis.validate`) that `compile_spec(validate=True)`
runs over every artifact, and the lane-shape retrace detector
(`repro_torch.analysis.retrace`) the serving tier's scrape reads."""
from repro_torch.analysis.retrace import (RetraceDetector, RetraceError,
                                          compile_counts)
from repro_torch.analysis.validate import (AnalysisError, AnalysisReport,
                                           Finding, validate_compiled,
                                           validate_spec)

__all__ = ["AnalysisError", "AnalysisReport", "Finding",
           "validate_compiled", "validate_spec", "RetraceDetector",
           "RetraceError", "compile_counts"]
