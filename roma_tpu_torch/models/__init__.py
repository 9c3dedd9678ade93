from .config import RefinerSpec, RoMaConfig
from .matcher import RoMaNet
from .roma import RegressionMatcher
from .zoo import pretrained_backbone, roma_indoor, roma_outdoor, train_net

__all__ = ["RefinerSpec", "RegressionMatcher", "RoMaConfig", "RoMaNet", "pretrained_backbone", "roma_indoor",
           "roma_outdoor", "train_net"]
