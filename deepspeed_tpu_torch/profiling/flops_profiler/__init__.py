from .profiler import (FlopsProfiler, cost_analysis_of, flops_to_string,
                       get_detailed_profile, get_model_profile,
                       macs_to_string, number_to_string,
                       params_to_string)

__all__ = ["FlopsProfiler", "get_model_profile", "get_detailed_profile",
           "cost_analysis_of",
           "flops_to_string", "macs_to_string", "params_to_string",
           "number_to_string"]
