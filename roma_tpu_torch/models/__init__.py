from .config import RefinerSpec, RoMaConfig
from .matcher import RoMaNet
from .roma import RegressionMatcher
from .tiny import TinyRoMa, TinyRoMaNet
from .xfeat import XFeatBackbone
from .zoo import pretrained_backbone, roma_indoor, roma_outdoor, tiny_roma_v1_outdoor, train_net

__all__ = ["RefinerSpec", "RegressionMatcher", "RoMaConfig", "RoMaNet", "TinyRoMa", "TinyRoMaNet", "XFeatBackbone",
           "pretrained_backbone", "roma_indoor", "roma_outdoor", "tiny_roma_v1_outdoor", "train_net"]
