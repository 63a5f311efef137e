"""YCB-Video class tables.

Own copy of ``morefusion_tpu/datasets/ycb_video/class_names.py``: 21
foreground classes, 5 of them treated as symmetric by the ADD-S protocol.
"""

import numpy as np

class_names = np.array(
    [
        "__background__",
        "002_master_chef_can",
        "003_cracker_box",
        "004_sugar_box",
        "005_tomato_soup_can",
        "006_mustard_bottle",
        "007_tuna_fish_can",
        "008_pudding_box",
        "009_gelatin_box",
        "010_potted_meat_can",
        "011_banana",
        "019_pitcher_base",
        "021_bleach_cleanser",
        "024_bowl",
        "025_mug",
        "035_power_drill",
        "036_wood_block",
        "037_scissors",
        "040_large_marker",
        "051_large_clamp",
        "052_extra_large_clamp",
        "061_foam_brick",
    ]
)
class_names.setflags(write=False)

class_names_symmetric = np.array(
    [
        "024_bowl",
        "036_wood_block",
        "051_large_clamp",
        "052_extra_large_clamp",
        "061_foam_brick",
    ]
)
class_names_symmetric.setflags(write=False)

class_ids_symmetric = np.array(
    [int(np.where(class_names == n)[0][0]) for n in class_names_symmetric],
    dtype=np.int32,
)
class_ids_symmetric.setflags(write=False)

n_classes = len(class_names)  # 22 incl. background
n_fg_classes = n_classes - 1  # 21


def symmetric_flags(n_fg_class: int = n_fg_classes) -> np.ndarray:
    """(n_fg_class,) bool table indexed by zero-based fg class id."""
    flags = np.zeros(n_fg_class, dtype=bool)
    for cid in class_ids_symmetric:
        if 0 <= cid - 1 < n_fg_class:
            flags[cid - 1] = True
    return flags
