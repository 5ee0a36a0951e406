from shockwave_tpu_torch.data.trace import parse_trace, write_trace
from shockwave_tpu_torch.data.throughputs import read_throughputs
from shockwave_tpu_torch.data.profiles import synthesize_profiles, load_or_synthesize_profiles
from shockwave_tpu_torch.data import bs_patterns

__all__ = [
    "parse_trace",
    "write_trace",
    "read_throughputs",
    "synthesize_profiles",
    "load_or_synthesize_profiles",
    "bs_patterns",
]
