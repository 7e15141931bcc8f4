"""The scene-coordinate CNN (port of dsac_tpu/models)."""

from dsac_tpu_torch.models.coord_net import DenseCoordNet, gather_dense_coords
