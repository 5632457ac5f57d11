from .graph import TimingGraph, build_timing_graph
from .sta import TimingAnalyzer, sta_crit
