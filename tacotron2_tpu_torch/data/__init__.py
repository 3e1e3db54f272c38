"""Data pipeline of the port: filelist datasets, bucketing, host prefetch."""

from tacotron2_tpu_torch.data.bucketing import (BucketSampler, mel_bucket,
                                                pad_batch, text_bucket)
from tacotron2_tpu_torch.data.dataset import (TextMelDataset, load_filelist,
                                              load_wav, mel_spectrogram_np)
from tacotron2_tpu_torch.data.pipeline import (DataPipeline, DeviceTransfer,
                                               prefetch)

__all__ = [
    "TextMelDataset", "load_filelist", "load_wav", "mel_spectrogram_np",
    "BucketSampler", "pad_batch", "text_bucket", "mel_bucket",
    "DataPipeline", "DeviceTransfer", "prefetch",
]
