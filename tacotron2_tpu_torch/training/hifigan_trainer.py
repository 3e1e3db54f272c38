"""HiFi-GAN training on the port: adversarial (MPD + MSD), feature
matching and mel-L1 objectives, two AdamW optimizers.

Counterpart of the JAX package's ``training/hifigan_trainer.py``, on the
same ``segment_sampler`` crops as the WaveGlow trainer. A step updates the
discriminators on (real, detached fake) and then the generator against the
*updated* discriminators. Both optimizers are ``make_optimizer``'s: optax's
``adamw`` at the paper's betas (0.8, 0.99), eps 1e-8 and optax's default
weight decay of 1e-4 (``torch.optim.AdamW``'s own default is 1e-2), with
the learning rate decayed by 0.999 every 1000 steps (staircase). The
mel-L1 term differentiates through the plain ``audio/mel.py``
``mel_spectrogram`` (the fused mel kernel has no backward), as the JAX
package does through its XLA form. ``tools/train_hifigan.py`` is the
command line.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from tacotron2_tpu_torch.audio.mel import MelConfig, mel_spectrogram
from tacotron2_tpu_torch.models import hifigan
from tacotron2_tpu_torch.models.tacotron2 import resolve_device
from tacotron2_tpu_torch.training.checkpoint import Checkpointer, host_tree
from tacotron2_tpu_torch.training.vocoder_trainer import (VocoderBatch,
                                                          segment_sampler)

ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.8, 0.99), 1e-8, 1e-4
LR_DECAY, DECAY_EVERY = 0.999, 1000
MEL_L1_WEIGHT = 45.0


def make_optimizer(params, learning_rate: float = 2e-4) -> torch.optim.AdamW:
    """AdamW as the JAX package's ``make_optimizer`` (``optax.adamw``)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=ADAMW_BETAS,
                             eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)


def learning_rate_at(step: int, learning_rate: float) -> float:
    """``optax.exponential_decay(lr, 1000, 0.999, staircase=True)`` at
    ``step`` updates."""
    return learning_rate * LR_DECAY ** (step // DECAY_EVERY)


class HiFiGANLosses(NamedTuple):
    disc: torch.Tensor
    gen_adv: torch.Tensor
    feature: torch.Tensor
    mel_l1: torch.Tensor

    @property
    def gen_total(self) -> torch.Tensor:
        return self.gen_adv + self.feature + MEL_L1_WEIGHT * self.mel_l1


class HiFiGANTrainState(NamedTuple):
    """The step count, the three networks and the two optimizers (the
    discriminators share one), which train in place."""
    step: int
    generator: hifigan.Generator
    mpd: hifigan.MultiPeriodDiscriminator
    msd: hifigan.MultiScaleDiscriminator
    gen_opt: torch.optim.AdamW
    disc_opt: torch.optim.AdamW
    learning_rate: float  # the schedule's initial rate

    def snapshot(self) -> dict:
        """The checkpoint dict (``training/checkpoint.py``), host copies;
        ``state_dict`` is the generator's (what inference loads)."""
        return {"kind": "hifigan",
                "config": dict(self.generator.cfg._asdict()),
                "state_dict": host_tree(self.generator.state_dict()),
                "mpd": host_tree(self.mpd.state_dict()),
                "msd": host_tree(self.msd.state_dict()),
                "gen_optimizer": host_tree(self.gen_opt.state_dict()),
                "disc_optimizer": host_tree(self.disc_opt.state_dict()),
                "iteration": int(self.step),
                "learning_rate": learning_rate_at(self.step,
                                                  self.learning_rate)}

    def restored(self, ckpt: dict) -> "HiFiGANTrainState":
        """This state with a checkpoint dict loaded in place."""
        if ckpt.get("kind") != "hifigan":
            raise ValueError(f"not a hifigan checkpoint: kind "
                             f"{ckpt.get('kind')!r}")
        for module, key in ((self.generator, "state_dict"),
                            (self.mpd, "mpd"), (self.msd, "msd")):
            module.load_state_dict(ckpt[key], strict=True)
        self.gen_opt.load_state_dict(ckpt["gen_optimizer"])
        self.disc_opt.load_state_dict(ckpt["disc_optimizer"])
        return self._replace(step=int(ckpt["iteration"]))


def create_hifigan_state(cfg: hifigan.HiFiGANConfig,
                         learning_rate: float = 2e-4, *,
                         generator: Optional[torch.Generator] = None,
                         device: Union[str, torch.device] = "cuda"
                         ) -> HiFiGANTrainState:
    """Fresh networks, N(0, 0.01) from ``generator``, on ``device`` (CUDA
    unless the caller asks for the CPU), and their optimizers."""
    device = resolve_device(device)
    gen = hifigan.Generator(cfg, generator, trainable=True).to(device)
    mpd = hifigan.MultiPeriodDiscriminator(cfg, generator).to(device)
    msd = hifigan.MultiScaleDiscriminator(cfg, generator).to(device)
    return HiFiGANTrainState(
        0, gen, mpd, msd, make_optimizer(gen.parameters(), learning_rate),
        make_optimizer([*mpd.parameters(), *msd.parameters()],
                       learning_rate), learning_rate)


def hifigan_train_step(state: HiFiGANTrainState, batch: VocoderBatch,
                       cfg: hifigan.HiFiGANConfig, mel_cfg: MelConfig
                       ) -> tuple:
    """One GAN step on the state's device: the discriminators on (real,
    detached fake), then the generator against the updated
    discriminators. Returns (new state, HiFiGANLosses)."""
    lr = learning_rate_at(state.step, state.learning_rate)
    for opt in (state.gen_opt, state.disc_opt):
        for group in opt.param_groups:
            group["lr"] = lr
    y_hat = hifigan.generator(state.generator, batch.mel, cfg)

    state.disc_opt.zero_grad(set_to_none=True)
    real_lg, _ = hifigan.discriminate(state.mpd, state.msd, batch.audio)
    fake_lg, _ = hifigan.discriminate(state.mpd, state.msd, y_hat.detach())
    d_loss = hifigan.discriminator_loss(real_lg, fake_lg)
    d_loss.backward()
    state.disc_opt.step()

    with torch.no_grad():
        mel_real = mel_spectrogram(batch.audio, mel_cfg)
        _, real_fm = hifigan.discriminate(state.mpd, state.msd, batch.audio)
    fake_lg, fake_fm = hifigan.discriminate(state.mpd, state.msd, y_hat)
    adv = hifigan.generator_adversarial_loss(fake_lg)
    fm = hifigan.feature_matching_loss(real_fm, fake_fm)
    mel_l1 = torch.mean(torch.abs(mel_spectrogram(y_hat, mel_cfg)
                                  - mel_real))
    losses = HiFiGANLosses(d_loss.detach(), adv, fm, mel_l1)
    params = list(state.generator.parameters())
    # the generator's gradients only: the discriminators take none here
    grads = torch.autograd.grad(losses.gen_total, params)
    for p, g in zip(params, grads):
        p.grad = g
    state.gen_opt.step()
    state.gen_opt.zero_grad(set_to_none=True)
    return (state._replace(step=state.step + 1),
            HiFiGANLosses(*(x.detach() for x in losses)))


def train_hifigan(dataset, out_dir: str,
                  cfg: hifigan.HiFiGANConfig = hifigan.HiFiGANConfig(),
                  mel_cfg: MelConfig = MelConfig(),
                  steps: int = 100000, batch_size: int = 16,
                  segment_mels: int = 32, learning_rate: float = 2e-4,
                  log_every: int = 100, checkpoint_every: int = 5000,
                  seed: int = 1234,
                  device: Union[str, torch.device] = "cuda"
                  ) -> HiFiGANTrainState:
    """The training loop (``tools/train_hifigan.py`` wraps it): ``steps``
    steps from fresh networks seeded ``seed``, a checkpoint every
    ``checkpoint_every`` steps and one at the end."""
    if cfg.hop_length != mel_cfg.hop_length:
        raise ValueError(f"the generator's upsampling ({cfg.hop_length}) "
                         f"must multiply out to the mel hop length "
                         f"({mel_cfg.hop_length})")
    device = resolve_device(device)
    state = create_hifigan_state(
        cfg, learning_rate, generator=torch.Generator().manual_seed(seed),
        device=device)
    ckpt = Checkpointer(out_dir)
    batches = segment_sampler(dataset, mel_cfg, segment_mels, batch_size,
                              seed)
    for i in range(steps):
        batch = VocoderBatch(*(t.to(device, non_blocking=True)
                               for t in next(batches)))
        state, losses = hifigan_train_step(state, batch, cfg, mel_cfg)
        if i % log_every == 0:
            print(f"hifigan step {state.step}: d {float(losses.disc):.4f} "
                  f"adv {float(losses.gen_adv):.4f} "
                  f"fm {float(losses.feature):.4f} "
                  f"mel {float(losses.mel_l1):.4f}", flush=True)
        if state.step % checkpoint_every == 0:
            ckpt.save(state)
    ckpt.save(state, wait=True)
    return state
