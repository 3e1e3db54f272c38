"""WaveGlow training on the port.

Counterpart of the JAX package's ``training/vocoder_trainer.py``: random
fixed-length audio crops with their aligned mels (``segment_sampler``) ->
the flow's maximum-likelihood objective (``models/waveglow.loss``) -> Adam
(optax's defaults: betas 0.9, 0.999, eps 1e-8), checkpoints through
``training/checkpoint.Checkpointer``. ``tools/train_vocoder.py`` is the
command line. The flow is plain torch (cuDNN convolutions on the card), as
the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Union

import numpy as np
import torch

from tacotron2_tpu_torch.audio.mel import MelConfig
from tacotron2_tpu_torch.models import waveglow
from tacotron2_tpu_torch.models.tacotron2 import resolve_device
from tacotron2_tpu_torch.training.checkpoint import Checkpointer, host_tree


class VocoderBatch(NamedTuple):
    audio: torch.Tensor  # (B, segment_samples) fp32 in [-1, 1]
    mel: torch.Tensor    # (B, T_mel, n_mels) fp32, aligned with the audio


class VocoderTrainState(NamedTuple):
    """The step count and the flow and its optimizer, which train in
    place."""
    step: int
    model: waveglow.WaveGlow
    optimizer: torch.optim.Adam

    def snapshot(self) -> dict:
        """The checkpoint dict (``training/checkpoint.py``), host copies."""
        return {"kind": "waveglow",
                "config": dict(self.model.cfg._asdict()),
                "state_dict": host_tree(self.model.state_dict()),
                "optimizer": host_tree(self.optimizer.state_dict()),
                "iteration": int(self.step),
                "learning_rate": float(self.optimizer.param_groups[0]["lr"])}

    def restored(self, ckpt: dict) -> "VocoderTrainState":
        """This state with a checkpoint dict loaded in place."""
        if ckpt.get("kind") != "waveglow":
            raise ValueError(f"not a waveglow checkpoint: kind "
                             f"{ckpt.get('kind')!r}")
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        self.optimizer.load_state_dict(ckpt["optimizer"])
        return self._replace(step=int(ckpt["iteration"]))


def create_vocoder_state(cfg: waveglow.WaveGlowConfig,
                         learning_rate: float = 1e-4, *,
                         generator: Optional[torch.Generator] = None,
                         device: Union[str, torch.device] = "cuda"
                         ) -> VocoderTrainState:
    """A fresh flow (the JAX package's init, from ``generator``) on
    ``device`` (CUDA unless the caller asks for the CPU) and its Adam."""
    model = waveglow.WaveGlow(cfg, generator).to(resolve_device(device))
    return VocoderTrainState(0, model.train(),
                             torch.optim.Adam(model.parameters(),
                                              lr=learning_rate))


def vocoder_train_step(state: VocoderTrainState, batch: VocoderBatch,
                       cfg: waveglow.WaveGlowConfig, sigma: float = 1.0
                       ) -> tuple:
    """One NLL step on the state's device: (new state, loss)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = waveglow.loss(waveglow.forward(state.model, batch.audio,
                                          batch.mel, cfg), sigma=sigma)
    loss.backward()
    state.optimizer.step()
    return state._replace(step=state.step + 1), loss.detach()


def segment_sampler(dataset, mel_cfg: MelConfig, segment_mels: int,
                    batch_size: int, seed: int = 0
                    ) -> Iterator[VocoderBatch]:
    """Endless random fixed-length (audio, mel) crops from a
    ``data.TextMelDataset`` (WaveGlow's regime: short random segments),
    as host tensors: audio segment_mels * hop samples from a random start,
    the mel frames from start // hop on. Utterances shorter than a segment
    and a hop are skipped. The draws are the JAX package's, from a numpy
    ``RandomState(seed)``."""
    from tacotron2_tpu_torch.data.dataset import load_wav
    rng = np.random.RandomState(seed)
    hop = mel_cfg.hop_length
    seg_samples = segment_mels * hop
    n = len(dataset)
    while True:
        audio_rows, mel_rows = [], []
        while len(audio_rows) < batch_size:
            idx = rng.randint(n)
            wav, _ = load_wav(dataset.entries[idx][0])
            wav = wav / 32768.0
            if len(wav) < seg_samples + hop:
                continue
            start = rng.randint(len(wav) - seg_samples)
            _, full_mel = dataset[idx]  # (n_mels, T)
            mel = full_mel[:, start // hop:start // hop + segment_mels]
            if mel.shape[1] < segment_mels:
                continue
            audio_rows.append(wav[start:start + seg_samples]
                              .astype(np.float32))
            mel_rows.append(mel.T.astype(np.float32))
        yield VocoderBatch(torch.from_numpy(np.stack(audio_rows)),
                           torch.from_numpy(np.stack(mel_rows)))


def train_vocoder(dataset, out_dir: str,
                  cfg: waveglow.WaveGlowConfig = waveglow.WaveGlowConfig(),
                  mel_cfg: MelConfig = MelConfig(),
                  steps: int = 100000, batch_size: int = 8,
                  segment_mels: int = 64, learning_rate: float = 1e-4,
                  log_every: int = 100, checkpoint_every: int = 5000,
                  seed: int = 1234,
                  device: Union[str, torch.device] = "cuda"
                  ) -> VocoderTrainState:
    """The training loop (``tools/train_vocoder.py`` wraps it): ``steps``
    steps from a fresh flow seeded ``seed``, a checkpoint every
    ``checkpoint_every`` steps and one at the end."""
    device = resolve_device(device)
    state = create_vocoder_state(
        cfg, learning_rate, generator=torch.Generator().manual_seed(seed),
        device=device)
    ckpt = Checkpointer(out_dir)
    batches = segment_sampler(dataset, mel_cfg, segment_mels, batch_size,
                              seed)
    for i in range(steps):
        batch = VocoderBatch(*(t.to(device, non_blocking=True)
                               for t in next(batches)))
        state, loss = vocoder_train_step(state, batch, cfg)
        if i % log_every == 0:
            print(f"vocoder step {state.step}: nll {float(loss):.4f}",
                  flush=True)
        if state.step % checkpoint_every == 0:
            ckpt.save(state)
    ckpt.save(state, wait=True)
    return state
