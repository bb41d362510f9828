from .engine import Engine, EngineResult, TrainState
from .trainer import TrainResult, evaluate_dnn, train_dnn_ssl
from .train_step import dnn_ssl_grads, dnn_ssl_loss, dnn_ssl_step

__all__ = ["Engine", "EngineResult", "TrainState", "TrainResult",
           "evaluate_dnn", "train_dnn_ssl", "dnn_ssl_loss", "dnn_ssl_grads",
           "dnn_ssl_step"]
