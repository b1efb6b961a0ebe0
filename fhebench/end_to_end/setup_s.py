"""Process start to the first timed job: imports, CUDA, the kernel libraries,
keys, plans, the client's input pool and the warm-up of the cell's shapes."""


def read(w):
    return w.setup_s
