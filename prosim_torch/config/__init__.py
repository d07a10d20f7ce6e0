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


__all__ = ["CfgNode", "get_config", "get_default_config", "fixup_derived_keys"]
