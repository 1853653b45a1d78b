"""setup_s: seconds from the process's start to the first timed call (host clock):
imports, the program's build and warm-up, and in a first run the kernels' build."""


def read(run):
    return run['setup_s']
