"""Data helpers of the port: text-length bucketing."""

from tacotron2_tpu_torch.data.bucketing import text_bucket

__all__ = ["text_bucket"]
