"""setup_s: process start to the first timed call (host clock): CUDA
set-up, the kernel libraries (built on a checkout's first run, loaded
after), the inputs, the index a query cell needs, the warm-up."""


def read(win):
    return win.setup_s
