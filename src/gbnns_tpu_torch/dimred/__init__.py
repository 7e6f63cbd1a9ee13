from gbnns_tpu_torch.dimred.models import LinearProjection, MLPProjection, make_model
from gbnns_tpu_torch.dimred.pca import PCAModel, pca_fit, pca_transform
from gbnns_tpu_torch.dimred.train import (TrainConfig, load_projection,
                                          params_from_jax, project, projector,
                                          save_projection, train_projection)

__all__ = ["LinearProjection", "MLPProjection", "make_model", "PCAModel",
           "pca_fit", "pca_transform", "TrainConfig", "train_projection",
           "save_projection", "load_projection", "params_from_jax", "project",
           "projector"]
