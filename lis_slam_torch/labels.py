"""Semantic label configuration (TPU-friendly lookup tables).

Rebuilds the reference's `SemanticLabelParam` (src/include/utility.h:122-229)
from `config/label.yaml` as dense int/float arrays indexable with `jnp.take`:

 - 20 learning classes (RangeNet++ output argmax ids 0..19),
 - `learning_map_inv`: learning id -> raw SemanticKITTI label,
 - `using_label`: learning id -> 5 super-categories
   {10 dynamic, 40 ground, 50 building, 81 pole, 70 outlier}
   (label.yaml:187-206, used by semanticFusionNode.cpp:173-189),
 - `label_sorce`: per-class matching weight 0.5-1.5 (label.yaml:214-234);
   residual weight is w = 2.0 - label_sorce[label]
   (subMapOptmizationNode.cpp:1671,1795),
 - SSC priority order (epscGeneration.h order_vec),
 - RGB color map for visualization (label.yaml color_map, BGR->RGB).
"""

from __future__ import annotations

import numpy as np

NUM_LEARNING_CLASSES = 20

LEARNING_CLASS_NAMES = (
    "unlabeled", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
)

# learning id -> raw SemanticKITTI label (label.yaml learning_map_inv)
LEARNING_MAP_INV = np.array(
    [0, 10, 11, 15, 18, 20, 30, 31, 32, 40, 44, 48, 49, 50, 51, 70, 71, 72, 80, 81],
    dtype=np.int32,
)

# Super-category ids (the five feature classes the pipeline carries)
CAT_UNLABELED = 0
CAT_DYNAMIC = 10
CAT_GROUND = 40
CAT_BUILDING = 50
CAT_OUTLIER = 70
CAT_POLE = 81

# learning id -> super-category (label.yaml using_label; id 0 stays unlabeled)
USING_LABEL_MAP = np.array(
    [
        CAT_UNLABELED,  # 0 unlabeled
        CAT_DYNAMIC,  # 1 car
        CAT_DYNAMIC,  # 2 bicycle
        CAT_DYNAMIC,  # 3 motorcycle
        CAT_DYNAMIC,  # 4 truck
        CAT_DYNAMIC,  # 5 other-vehicle
        CAT_DYNAMIC,  # 6 person
        CAT_DYNAMIC,  # 7 bicyclist
        CAT_DYNAMIC,  # 8 motorcyclist
        CAT_GROUND,  # 9 road
        CAT_GROUND,  # 10 parking
        CAT_GROUND,  # 11 sidewalk
        CAT_OUTLIER,  # 12 other-ground
        CAT_BUILDING,  # 13 building
        CAT_BUILDING,  # 14 fence
        CAT_OUTLIER,  # 15 vegetation
        CAT_POLE,  # 16 trunk
        CAT_OUTLIER,  # 17 terrain
        CAT_POLE,  # 18 pole
        CAT_POLE,  # 19 traffic-sign
    ],
    dtype=np.int32,
)

# learning id -> matching-weight score (label.yaml label_sorce).
# Residual weight in the semantic-weighted solver: w = 2.0 - LABEL_SCORE[label].
LABEL_SCORE = np.array(
    [1.0, 1.0, 0.6, 0.5, 0.8, 0.5, 0.5, 0.5, 0.5, 1.2,
     1.2, 1.2, 0.5, 1.0, 0.8, 0.5, 1.3, 0.5, 1.5, 1.5],
    dtype=np.float32,
)

# SSC label priority (epscGeneration.h order_vec: higher wins the cell)
SSC_ORDER = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 10, 11, 12, 13, 15, 16, 14, 17, 9, 18, 19],
    dtype=np.int32,
)

# learning id -> RGB (label.yaml color_map is BGR; converted here)
LEARNING_RGB = np.array(
    [
        (0, 0, 0),        # unlabeled
        (100, 150, 245),  # car
        (100, 230, 245),  # bicycle
        (30, 60, 150),    # motorcycle
        (80, 30, 180),    # truck
        (0, 0, 255),      # other-vehicle
        (255, 30, 30),    # person
        (255, 40, 200),   # bicyclist
        (150, 30, 90),    # motorcyclist
        (255, 0, 255),    # road
        (255, 150, 255),  # parking
        (75, 0, 75),      # sidewalk
        (175, 0, 75),     # other-ground
        (255, 200, 0),    # building
        (255, 120, 50),   # fence
        (0, 175, 0),      # vegetation
        (135, 60, 0),     # trunk
        (150, 240, 80),   # terrain
        (255, 240, 150),  # pole
        (255, 0, 0),      # traffic-sign
    ],
    dtype=np.uint8,
)

# Category ordering used for the per-class clouds in semantic_info
# (msg/semantic_info.msg: dynamic/ground/building/pole/outlier + unlabeled)
CATEGORY_IDS = np.array(
    [CAT_DYNAMIC, CAT_GROUND, CAT_BUILDING, CAT_POLE, CAT_OUTLIER], dtype=np.int32
)
CATEGORY_NAMES = ("dynamic", "ground", "building", "pole", "outlier")


def category_index(using_label: np.ndarray) -> np.ndarray:
    """Map super-category ids -> dense index 0..4 (-1 for unlabeled)."""
    out = np.full(using_label.shape, -1, dtype=np.int32)
    for i, cid in enumerate(CATEGORY_IDS):
        out[using_label == cid] = i
    return out


# learning id -> dense category index (0..4, -1 unlabeled)
LEARNING_TO_CATEGORY = category_index(USING_LABEL_MAP)

# learning id -> residual weight w = 2 - score
RESIDUAL_WEIGHT = (2.0 - LABEL_SCORE).astype(np.float32)
