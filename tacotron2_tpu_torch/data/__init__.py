"""Data helpers of the port: text- and mel-length bucketing."""

from tacotron2_tpu_torch.data.bucketing import mel_bucket, text_bucket

__all__ = ["text_bucket", "mel_bucket"]
