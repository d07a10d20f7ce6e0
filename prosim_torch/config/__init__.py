from typing import List, Optional

from prosim_torch.config.node import CfgNode
from prosim_torch.config.defaults import get_default_config, fixup_derived_keys


def get_config(
    config_paths: Optional[str] = None,
    opts: Optional[List[str]] = None,
    freeze: bool = True,
) -> CfgNode:
    """Build a config: defaults <- yaml file(s) <- CLI opts.

    `config_paths` may be a comma-separated list of yaml files merged in order
    (reference: prosim/config/default.py:690-733).
    """
    config = get_default_config()
    if config_paths:
        for path in config_paths.split(","):
            config.merge_from_file(path.strip())
    if opts:
        config.merge_from_list(list(opts))
    config = fixup_derived_keys(config)
    if freeze:
        config.freeze()
    return config


def get_cond_set_config(config, cond_set_name: str, root: Optional[str] = None):
    """Clone `config` with PROMPT.CONDITION overridden by a condition-set yaml
    from configs/cond_sampler/ (reference: prosim/trainer.py:35-49) -- used to
    evaluate one checkpoint under several prompting regimes."""
    import os

    import yaml

    root = root or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "configs", "cond_sampler",
    )
    with open(os.path.join(root, cond_set_name + ".yaml")) as f:
        overrides = yaml.safe_load(f) or {}

    out = config.clone()
    out.defrost()
    out.PROMPT.CONDITION.merge_from_other(overrides)
    out.freeze()
    return out


__all__ = ["CfgNode", "get_config", "get_cond_set_config", "get_default_config",
           "fixup_derived_keys"]
