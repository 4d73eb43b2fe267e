"""Camera, image and SMPL constants used by the refinement and data paths
(values are dataset and model facts; copied from jrr_tpu/constants.py so the
port stands alone)."""

from __future__ import annotations

FOCAL_LENGTH = 5000.0
IMG_RES = 1000  # raw Human3.6M frames are cropped to 1000x1000
CROP_RES = 224  # SPIN / renderer working resolution
IMAGE_CROP_RES = 256  # secondary crop resolution emitted by the data pipeline

# ImageNet normalization of the SPIN backbone's input
# (reference: scripts/constants.py:4-5, scripts/optimize.py:141-142).
IMG_NORM_MEAN = (0.485, 0.456, 0.406)
IMG_NORM_STD = (0.229, 0.224, 0.225)

# Joint-index maps between the Human3.6M 32-joint annotation set, the 17-joint
# evaluation skeleton and other conventions (reference: scripts/constants.py:7-18).
GT_2_J17 = (0, 6, 7, 8, 1, 2, 3, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27)
J17_2_METRO = (0, 4, 5, 6, 1, 2, 3, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
H36M_J17_TO_J14_METRO = (3, 2, 1, 4, 5, 6, 16, 15, 14, 11, 12, 13, 8, 10)
H36M_TO_J17 = (6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9)
H36M_TO_J14 = H36M_TO_J17[:14]
J24_TO_J17 = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17)
J24_TO_J14 = J24_TO_J17[:14]

# SMPL pose-parameter indices frozen by `freeze_hand_feet`
# (reference: scripts/constants.py:18, scripts/create_smpl_gt.py:757).
HAND_FEET_ROT_INDICES = (6, 7, 9, 10, 19, 20, 21, 22)

# Number of joints in the evaluation skeleton (the retrained regressor rows).
NUM_EVAL_JOINTS = 17
NUM_SMPL_JOINTS = 24
NUM_SMPL_VERTS = 6890
NUM_SMPL_FACES = 13776
NUM_BETAS = 10
