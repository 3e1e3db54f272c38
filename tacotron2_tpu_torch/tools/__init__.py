"""Tools of the port: the tone-corpus training demo, the quality gate, the
two vocoder trainers, the benchmarks (``bench_buckets``, ``bench_default``,
``bench_details``; the headline is ``tacotron2_tpu_torch.bench``), the mel
cache and the inference demo."""
