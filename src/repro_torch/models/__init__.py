from .dnn import DNNConfig, dnn_forward, dnn_hidden, init_dnn

__all__ = ["DNNConfig", "init_dnn", "dnn_forward", "dnn_hidden"]
