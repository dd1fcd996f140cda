"""Process start to the window's start: imports, the kernel library's
build or load, inputs, the program's construction, capture and warm-up."""

UNIT = "s"


def read(rec):
    return rec["t_start"] - rec["t_process"]
