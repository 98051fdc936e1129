"""Full-graph and neighbor-sampled training, and geolocation evaluation."""

from graphconvgeo_torch.train.evaluate import geo_eval, haversine_km  # noqa: F401
from graphconvgeo_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
from graphconvgeo_torch.train.trainer_sampled import SampledTrainer  # noqa: F401
