"""Training CLI of the port.

Same surface as the JAX package's ``train.py`` (reference train.py:258-290),
plus ``--device``:

    python -m tacotron2_tpu_torch.train -o outdir -l logdir \
        [-c CKPT] [--warm_start] [--hparams k=v,k=v] [--device cuda|cpu]

It trains on one CUDA device unless ``--device cpu`` is given, and stops
with an error when CUDA is asked for and no card is present. Under
torchrun it trains data-parallel, one rank a card (NCCL; gloo with
``--device cpu``), ``batch_size`` being the global batch:

    torchrun --nproc_per_node=N -m tacotron2_tpu_torch.train -o outdir ...

``--hparams mesh_shape=dp+mp`` (the config's tuple syntax: ``,`` separates
the pairs) lays the N = dp * mp ranks on a ``(dp, mp)`` mesh: the batch
split over dp, the Adam moments of the wide weights sharded over mp
(``parallel/``).
"""

from __future__ import annotations

import argparse

import torch

from tacotron2_tpu_torch.config import create_config
from tacotron2_tpu_torch.data import DataPipeline, TextMelDataset
from tacotron2_tpu_torch.training.trainer import Trainer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--output_directory", type=str, required=True,
                        help="directory for checkpoints")
    parser.add_argument("-l", "--log_directory", type=str, default="logs",
                        help="directory for logs (under output_directory)")
    parser.add_argument("-c", "--checkpoint_path", type=str, default=None,
                        help="checkpoint to resume from")
    parser.add_argument("--warm_start", action="store_true",
                        help="load model weights only, ignoring "
                             "config.ignore_layers")
    parser.add_argument("--hparams", type=str, default=None,
                        help="comma separated name=value pairs")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    config = create_config(args.hparams)

    trainer = Trainer(
        config, args.output_directory, args.log_directory,
        checkpoint_path=None if args.warm_start else args.checkpoint_path,
        warm_start_path=args.checkpoint_path if args.warm_start else None,
        device=args.device)

    # every rank reads the same global batches and takes its rows of each
    whole = dict(process_index=0, process_count=1)
    train_data = DataPipeline(
        TextMelDataset(config.training_files, config), config, **whole)
    val_data = DataPipeline(
        TextMelDataset(config.validation_files, config, shuffle=False),
        config, drop_last=False, **whole)

    trainer.fit(train_data, val_data)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
