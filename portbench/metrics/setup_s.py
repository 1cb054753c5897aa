"""Set-up: from the process's start until the window opens (traffic made,
kernels built or loaded, the query spectra, the warm-up scans)."""


def read(run):
    return run.setup_s
