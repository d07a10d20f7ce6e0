"""Motion-tag vocabularies (the port's copy of the two enums of
prosim_tpu/data/motion_tags.py). The tag encoders size their parameter banks
from them, and data rows carry the tag's value as its id."""

from enum import IntEnum


class VActionTag(IntEnum):
    """Unary tag vocab; values match the reference enum
    (reference: prosim/dataset/motion_tag_utils.py:4-15)."""

    Stopping = 0
    Accelerate = 1
    Decelerate = 2
    KeepSpeed = 3
    LeftLaneChange = 4
    RightLaneChange = 5
    KeepLane = 6
    LeftTurn = 7
    RightTurn = 8
    Straight = 9
    Parked = 10


class V2VTag(IntEnum):
    """Binary (pair) tag vocab (reference: motion_tag_utils.py:17-22)."""

    Following = 0
    ParallelDriving = 1
    Merging = 2
    ByPassing = 3
    Overtaking = 4
