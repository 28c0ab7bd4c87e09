"""Device idle share of the traced sub-window (train cells): 1 - the union
of kernel intervals (copies and fills left out) over the sub-window's
length on the profiler's clock, in %."""
from benchmark.readings import idle_share as read  # noqa: F401
