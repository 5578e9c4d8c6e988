"""setup_s: from the process's start to the window's first call (imports,
weights made on the device, the program built, the kernels built or loaded,
one warm-up call at the cell's shape). Host clock."""


def read(run):
    return run["setup_s"]
