"""`ProSim.prepare` (scene encoder, prompt encoder, decoder) per call, in ms:
the mean of the traced window's host-clock spans around the benchmark's own
call of `prepare`, each ended by a synchronise."""


def read(record):
    s = record["spans"].get("prepare_s")
    return 1e3 * sum(s) / len(s) if s else None
