"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each beside
its plain PyTorch version: ``encoder_lstm`` and ``decoder_batch``."""
