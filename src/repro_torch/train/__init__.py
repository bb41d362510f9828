from .engine import (AsyncCarry, AsyncPSStrategy, Engine, EngineResult,
                     SequentialStrategy, SyncMeshStrategy, TrainState,
                     data_group)
from .trainer import TrainResult, evaluate_dnn, train_dnn_ssl
from .async_trainer import train_dnn_ssl_async
from .train_step import dnn_ssl_grads, dnn_ssl_loss, dnn_ssl_step

__all__ = ["Engine", "EngineResult", "TrainState", "TrainResult",
           "SequentialStrategy", "SyncMeshStrategy", "AsyncPSStrategy",
           "AsyncCarry", "data_group", "evaluate_dnn", "train_dnn_ssl",
           "train_dnn_ssl_async", "dnn_ssl_loss", "dnn_ssl_grads",
           "dnn_ssl_step"]
