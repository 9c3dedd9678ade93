from .config import RefinerSpec, RoMaConfig
from .matcher import RoMaNet
from .roma import RegressionMatcher
from .zoo import roma_outdoor, train_net

__all__ = ["RefinerSpec", "RegressionMatcher", "RoMaConfig", "RoMaNet", "roma_outdoor", "train_net"]
