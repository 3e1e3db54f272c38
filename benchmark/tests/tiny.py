"""Small widths and a small run for the CPU tests of the benchmark."""

import json
import os
import time

import torch

from benchmark.loops.common import Run
from benchmark.guard import keep_out

keep_out()

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(**kw) -> dict:
    with open(os.path.join(HERE, "configs", "tacotron2-ljspeech.json")) as f:
        c = json.load(f)
    c.update(symbols_embedding_dim=16, encoder_embedding_dim=16,
             decoder_rnn_dim=24, prenet_dim=8, attention_rnn_dim=24,
             attention_dim=8, attention_location_n_filters=4,
             attention_location_kernel_size=5, postnet_embedding_dim=8,
             n_mel_channels=6, text_buckets=[16, 32, 48], mel_bucket_step=16,
             max_mel_length=128, compute_dtype="float32", max_decoder_steps=40)
    c.update(kw)
    return c


def run(workload, traffic, limits, tmp, seed=3, seconds=1.0, faults=(),
        cfg=None) -> Run:
    return Run(workload=workload, seed=seed, seconds=seconds, trace=False,
               config=cfg or config(), traffic=traffic, limits=limits,
               device=torch.device("cpu"), scratch=str(tmp),
               t_start=time.perf_counter(), faults=tuple(faults))
