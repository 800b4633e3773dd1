"""Process start to the first timed request: imports, the kernel library
(built in the checkout's first run), keys, the request pool, warm-up."""


def read(w):
    return w.setup_s
