"""The scene-coordinate CNN and the hypothesis-score CNN (port of
dsac_tpu/models)."""

from dsac_tpu_torch.models.coord_net import DenseCoordNet, gather_dense_coords
from dsac_tpu_torch.models.score_net import ScoreNet
