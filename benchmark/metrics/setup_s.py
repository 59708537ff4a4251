"""Set-up: seconds from the start of the process to the start of the
window (interpreter and torch, the CUDA context, the input frames, the
checkpoint and handler, the counts, the kernel library's load or first
build, the warm windows). Host clock."""


def read(run):
    return run.setup_s
