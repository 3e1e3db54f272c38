"""NN primitives: dense/conv/batchnorm/dropout, LSTM cells and scans,
initializers."""

from tacotron2_tpu_torch.ops.layers import (
    batchnorm, conv1d, dense, dropout, length_mask,
)
from tacotron2_tpu_torch.ops.lstm import (
    LSTMWeights, bilstm, lstm_apply_gates, lstm_cell, lstm_gates, lstm_scan,
    lstm_weights,
)

__all__ = [
    "dense", "conv1d", "batchnorm", "dropout", "length_mask", "LSTMWeights",
    "lstm_weights", "lstm_gates", "lstm_apply_gates", "lstm_cell",
    "lstm_scan", "bilstm",
]
