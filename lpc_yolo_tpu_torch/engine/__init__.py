"""Engine of the port: YOLO facade, predictor, results, train step, trainer, validator."""

from .model import YOLO, YOLOWorld
from .predictor import Predictor, load_source
from .results import Boxes, Masks, Results
from .train_step import OptConfig, TrainState, init_train_state, lr_at, make_train_step, momentum_at
from .trainer import Trainer
from .validator import Validator

__all__ = ["YOLO", "YOLOWorld", "Predictor", "load_source", "Boxes", "Masks", "Results",
           "OptConfig", "TrainState", "init_train_state", "make_train_step", "lr_at", "momentum_at", "Trainer",
           "Validator"]
