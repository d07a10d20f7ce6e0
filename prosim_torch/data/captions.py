"""Human-readable captions for prompt conditions (visualization aid; the
port's copy of prosim_tpu/data/captions.py, on the port's `Condition`,
whose leaves may be numpy arrays or tensors on any device).

Mirrors the reference `caption_funcs` (reference:
prosim/dataset/condition_utils.py:545-643): short strings describing the
active conditions of scene `bidx`, used as figure titles/legends. Operates on
the padded `Condition` containers plus the host-side raw text list kept by
the dataset for OneText conditions.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from prosim_torch.data.batch import Condition
from prosim_torch.data.motion_tags import V2VTag, VActionTag


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def goal_caption(cond: Condition, bidx: int = 0, **_) -> str:
    return "shown as green cross"


def drag_point_caption(cond: Condition, bidx: int = 0, **_) -> str:
    return "shown as blue dots"


def v_action_tag_caption(cond: Condition, bidx: int = 0, **_) -> str:
    feat = _np(cond.feat[bidx])
    mask = _np(cond.mask[bidx])
    pidx = _np(cond.prompt_idx[bidx])
    parts = []
    for c in np.nonzero(mask)[0]:
        tag = VActionTag(int(feat[c, 0])).name
        start_t, end_t = int(feat[c, 1]), int(feat[c, 2])
        parts.append(f"{tag}(<A{int(pidx[c, 0])}>: {start_t}-{end_t})")
    return ", ".join(parts)


def v2v_tag_caption(cond: Condition, bidx: int = 0, **_) -> str:
    feat = _np(cond.feat[bidx])
    mask = _np(cond.mask[bidx])
    pidx = _np(cond.prompt_idx[bidx])
    parts = []
    for c in np.nonzero(mask)[0]:
        tag = V2VTag(int(feat[c, 0])).name
        start_t, end_t = int(feat[c, 1]), int(feat[c, 2])
        parts.append(
            f"{tag}(<A{int(pidx[c, 0])}>, <A{int(pidx[c, 1])}>: {start_t}-{end_t})"
        )
    return ", ".join(parts)


def one_text_caption(cond: Condition, bidx: int = 0,
                     texts: Optional[List[str]] = None, **_) -> str:
    if texts is None or bidx >= len(texts):
        return ""
    mask = _np(cond.mask)
    if mask.ndim >= 1 and not mask[bidx].any():
        return ""
    return texts[bidx]


caption_funcs = {
    "goal": goal_caption,
    "drag_point": drag_point_caption,
    "drag_points": drag_point_caption,
    "v_action_tag": v_action_tag_caption,
    "v2v_tag": v2v_tag_caption,
    "motion_tag_OneText": one_text_caption,
    "goal_OneText": one_text_caption,
    "llm_text_OneText": one_text_caption,
}


def batch_caption(conditions: Dict[str, Condition], bidx: int = 0,
                  texts: Optional[List[str]] = None) -> str:
    """One caption line per active condition type of scene `bidx`."""
    lines = []
    for ctype, cond in conditions.items():
        fn = caption_funcs.get(ctype)
        if fn is None:
            continue
        cap = fn(cond, bidx=bidx, texts=texts)
        if cap:
            lines.append(f"{ctype}: {cap}")
    return "\n".join(lines)
