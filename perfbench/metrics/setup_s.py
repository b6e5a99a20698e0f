"""setup_s: seconds from the start of the run to the open of its window
(imports, the model, the server and its kernels, the warm-up)."""


def read(rec):
    return rec["setup_s"]
