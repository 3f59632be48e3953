from mpx_torch.utils.profile import BenchmarkProfile, phase
from mpx_torch.utils.timer import Timer

__all__ = ["Timer", "BenchmarkProfile", "phase"]
