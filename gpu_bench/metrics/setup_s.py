"""Seconds from the process's start to the window's opening: building or
loading the kernels, making the weights, warming the cell's shapes and
its traffic."""


def read(rec):
    return rec["setup_s"]
