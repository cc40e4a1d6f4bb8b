"""chunk_ms_p90: the 90th percentile (nearest rank) of the chunk cycles in
the measured window, in milliseconds. A cycle runs from one entry into
`IslandRunner.run_chunk` to the next (the last, to the solve's return): the
solver's latency to publish an improved solution, and how far a solve can
overrun its time limit."""

import math


def read(run):
    cycles = sorted(run["cycles_s"])
    return 1000.0 * cycles[max(0, math.ceil(0.9 * len(cycles)) - 1)]
