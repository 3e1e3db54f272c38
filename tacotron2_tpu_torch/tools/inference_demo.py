"""Inference demo: the reference's inference.ipynb as a script, on the port
(the counterpart of ``examples/inference_demo.py``).

    python -m tacotron2_tpu_torch.tools.inference_demo -c CHECKPOINT
        [--torch_checkpoint] [-t TEXT] [-o demo_out] [--hparams k=v,...]
        [--device cuda|cpu]

Flow (inference.ipynb cells 7-17): the config, a Tacotron 2 checkpoint (a
``checkpoint_<step>.pt`` of the port's trainer, or with
``--torch_checkpoint`` a reference-format state_dict such as the published
``tacotron2_statedict.pt``: ``infer.load_model`` reads both), the text, the
model's inference, Griffin-Lim. Writes ``demo.wav`` (int16, clipped) and
then ``mel.png``, ``alignment.png`` and ``gate.png``
(``training/logging.plot_*``). Without matplotlib the WAV is still written
and one line says the plots were not. A random model never fires its gate:
cap ``max_decoder_steps`` in ``--hparams``. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None):
    """Run the demo; returns its ``infer.SynthesisResult``."""
    from tacotron2_tpu_torch.config import create_config
    from tacotron2_tpu_torch.infer import load_model, synthesize
    from tacotron2_tpu_torch.models.tacotron2 import resolve_device

    parser = argparse.ArgumentParser(
        prog="python -m tacotron2_tpu_torch.tools.inference_demo")
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("--torch_checkpoint", action="store_true",
                        help="the checkpoint is a reference-format "
                             "state_dict")
    parser.add_argument("-t", "--text",
                        default="Waveglow is really awesome!")
    parser.add_argument("-o", "--outdir", default="demo_out")
    parser.add_argument("--hparams", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    cfg = create_config(args.hparams)
    device = resolve_device(args.device)
    model = load_model(args.checkpoint, cfg,
                       torch_format=args.torch_checkpoint, device=device)
    os.makedirs(args.outdir, exist_ok=True)
    [result] = synthesize(model, [args.text], cfg, vocoder="griffin_lim",
                          generator=torch.Generator(device).manual_seed(0),
                          device=device)

    import scipy.io.wavfile
    wav = np.clip(result.audio, -1, 1)
    scipy.io.wavfile.write(os.path.join(args.outdir, "demo.wav"),
                           cfg.sampling_rate, (wav * 32767).astype(np.int16))
    secs = result.mel.shape[0] * cfg.hop_length / cfg.sampling_rate
    try:
        plots = _write_plots(result, args.outdir)
    except ImportError as e:  # no matplotlib: the WAV alone
        print(f"wrote {args.outdir}/demo.wav ({secs:.2f}s); no plots "
              f"written: {e}")
    else:
        print(f"wrote {args.outdir}/demo.wav ({secs:.2f}s), plots "
              f"{', '.join(plots)}")
    return result


def _write_plots(result, outdir: str):
    """mel.png, alignment.png and gate.png through the training logger's
    plots; the names written."""
    from PIL import Image

    from tacotron2_tpu_torch.training.logging import (plot_alignment,
                                                      plot_gate, plot_mel)
    gate = 1.0 / (1.0 + np.exp(-result.gate.astype(np.float64)))
    images = {"mel.png": plot_mel(result.mel, "predicted mel"),
              "alignment.png": plot_alignment(result.alignment),
              "gate.png": plot_gate(np.zeros_like(gate), gate)}
    for name, image in images.items():
        Image.fromarray(image).save(os.path.join(outdir, name))
    return list(images)


if __name__ == "__main__":
    main()
