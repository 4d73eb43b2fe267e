"""Camera and SMPL constants used by the refinement path (values are dataset
and model facts; copied from jrr_tpu/constants.py so the port stands alone)."""

from __future__ import annotations

FOCAL_LENGTH = 5000.0
CROP_RES = 224  # SPIN / renderer working resolution

# SMPL pose-parameter indices frozen by `freeze_hand_feet`
# (reference: scripts/constants.py:18, scripts/create_smpl_gt.py:757).
HAND_FEET_ROT_INDICES = (6, 7, 9, 10, 19, 20, 21, 22)

NUM_SMPL_JOINTS = 24
NUM_SMPL_VERTS = 6890
NUM_SMPL_FACES = 13776
NUM_BETAS = 10
