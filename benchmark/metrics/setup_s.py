"""Process start to the first request of the window: the GGUF written from
the seed, the server started, /loadmodel (load, engine, cache, warm-up,
and on a checkout's first run the kernel build), the load generator
started."""


def read(run):
    return run.setup_s
