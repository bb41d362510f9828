from .engine import (AsyncCarry, AsyncPSStrategy, Engine, EngineResult,
                     SequentialStrategy, SyncMeshStrategy, TrainState,
                     data_group)
from .trainer import TrainResult, evaluate_dnn, train_dnn_ssl
from .async_trainer import train_dnn_ssl_async
from .train_step import (chunked_ce, dnn_ssl_grads, dnn_ssl_loss,
                         dnn_ssl_step, lm_grads, lm_loss, lm_supervised_step,
                         lm_train_step)

__all__ = ["Engine", "EngineResult", "TrainState", "TrainResult",
           "SequentialStrategy", "SyncMeshStrategy", "AsyncPSStrategy",
           "AsyncCarry", "data_group", "evaluate_dnn", "train_dnn_ssl",
           "train_dnn_ssl_async", "dnn_ssl_loss", "dnn_ssl_grads",
           "dnn_ssl_step", "chunked_ce", "lm_loss", "lm_grads",
           "lm_train_step", "lm_supervised_step"]
