"""Static network analysis for the port: the numpy validator
(`repro_torch.analysis.validate`) that `compile_spec(validate=True)`
runs over every artifact, and the run-path retrace detector
(`repro_torch.analysis.retrace`) that tests, benchmarks and the serving
tier's scrape read."""
from repro_torch.analysis.retrace import (RetraceDetector, RetraceError,
                                          compile_counts, jit_functions,
                                          no_retrace)
from repro_torch.analysis.validate import (AnalysisError, AnalysisReport,
                                           Finding, validate_compiled,
                                           validate_spec)

__all__ = ["AnalysisError", "AnalysisReport", "Finding",
           "validate_compiled", "validate_spec", "RetraceDetector",
           "RetraceError", "compile_counts", "no_retrace", "jit_functions"]
