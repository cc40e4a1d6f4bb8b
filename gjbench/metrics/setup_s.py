"""setup_s: seconds from the start of the process to the timed solve's
first chunk: imports, the device context, the kernel build where a cell
needs one, the instance, the warm-up solve, and the timed solve's own
domain, cotwin, greedy start and kernel build."""


def read(run):
    return run["setup_s"]
