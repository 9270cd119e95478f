"""sb_restarts_per_s (host clock): SB restarts completed in the window
(problems x restarts of every call that returned) over the window's
length; read as ``anneals_per_s`` reads its runs."""
from cardbench.metrics.anneals_per_s import read  # noqa: F401
