from gbnns_tpu_torch.dimred.models import LinearProjection, MLPProjection, make_model
from gbnns_tpu_torch.dimred.train import TrainConfig, load_projection, params_from_jax, project, projector

__all__ = ["LinearProjection", "MLPProjection", "make_model", "TrainConfig",
           "load_projection", "params_from_jax", "project", "projector"]
