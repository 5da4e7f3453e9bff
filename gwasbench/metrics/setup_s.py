"""Set-up seconds: from the harness's start to the window's (imports, the build where missing, the inputs, keygen, QC or encryption, the warm-up unit); host clock."""

from gwasbench import readers


def read(run):
    return run["setup_s"]
