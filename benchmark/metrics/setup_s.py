"""Set-up seconds: from the process's start to the first timed call (the
libraries built or found, weights made, scenes drawn, shapes warmed up)."""


def read(record):
    return record["setup_s"]
