"""HiFi-GAN training from a filelist, on the port.

    python -m tacotron2_tpu_torch.tools.train_hifigan filelist.txt \
        -o hifigan_out [--steps N] [--batch 16] [--segment-mels 32] \
        [--lr 2e-4] [--hparams k=v,...] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/train_hifigan.py``:
adversarial vocoder training (``training/hifigan_trainer.py``: multi-period
and multi-scale discriminators, feature matching, mel L1) on random
(audio, mel) segments of a ``path|text`` filelist (transcripts ignored),
writing ``checkpoint_<step>.pt`` files into the output directory, which
``python -m tacotron2_tpu_torch.infer --vocoder hifigan
--vocoder_checkpoint`` loads. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from tacotron2_tpu_torch.audio.mel import MelConfig
from tacotron2_tpu_torch.config import create_config
from tacotron2_tpu_torch.data import TextMelDataset
from tacotron2_tpu_torch.models import hifigan
from tacotron2_tpu_torch.training.hifigan_trainer import train_hifigan


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m tacotron2_tpu_torch.tools.train_hifigan")
    parser.add_argument("filelist")
    parser.add_argument("-o", "--outdir", required=True)
    parser.add_argument("--steps", type=int, default=100000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--segment-mels", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--checkpoint-every", type=int, default=5000)
    parser.add_argument("--hparams", default=None,
                        help="audio-config overrides (k=v,...)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = create_config(args.hparams)
    return train_hifigan(
        TextMelDataset(args.filelist, cfg), args.outdir,
        cfg=hifigan.HiFiGANConfig(n_mel_channels=cfg.n_mel_channels),
        mel_cfg=MelConfig.from_config(cfg), steps=args.steps,
        batch_size=args.batch, segment_mels=args.segment_mels,
        learning_rate=args.lr, log_every=args.log_every,
        checkpoint_every=args.checkpoint_every, seed=cfg.seed,
        device=args.device)


if __name__ == "__main__":
    main()
