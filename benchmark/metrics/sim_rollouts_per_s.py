"""Scene-replica rollouts (8 s each) finished per second of the window:
all the window's rollouts over all its time."""


def read(record):
    n = record["units"].get("rollouts")
    return None if not n else n / record["window_s"]
