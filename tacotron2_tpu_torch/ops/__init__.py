"""NN primitives: dense/conv/batchnorm/dropout, LSTM cells and scans,
initializers."""

from tacotron2_tpu_torch.ops.layers import (
    batchnorm, conv1d, conv_transpose1d, dense, dropout, length_mask,
)
from tacotron2_tpu_torch.ops.lstm import (
    LSTMWeights, QuantizedLSTMCell, QuantizedLSTMWeights, bilstm,
    lstm_apply_gates, lstm_cell, lstm_gates, lstm_scan, lstm_weights,
    quantize_lstm_params,
)

__all__ = [
    "dense", "conv1d", "conv_transpose1d", "batchnorm", "dropout",
    "length_mask", "LSTMWeights", "QuantizedLSTMWeights",
    "QuantizedLSTMCell", "quantize_lstm_params", "lstm_weights", "lstm_gates",
    "lstm_apply_gates", "lstm_cell", "lstm_scan", "bilstm",
]
