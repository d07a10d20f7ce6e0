"""One replan step of `ProSim.rollout` (step_env, the policy, the
integration), in ms: the mean host-clock span of the benchmark's call of
`rollout`, ended by a synchronise, over the replan steps of a call."""


def read(record):
    s = record["spans"].get("rollout_s")
    return 1e3 * sum(s) / len(s) / record["replan_steps"] if s else None
