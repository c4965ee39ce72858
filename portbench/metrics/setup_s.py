"""Process start to the first timed job or step: imports, the kernels'
build or load, the host's filter design, the inputs, the warm-up and the
capture."""


def read(rec):
    return rec.setup_s
