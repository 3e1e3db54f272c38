"""Train state and step functions (the JAX package's ``training/state.py``).

The reference's training runtime (reference train.py:149-255): clip the
gradient's global norm to 1.0, add L2 weight decay, Adam, times a
learning rate that the caller may change per step. ``guarded_update``
applies it and skips a step whose loss or gradient norm is not finite ON
THE DEVICE: it selects new or old values with ``torch.where`` on a
device-side flag and never reads a value back to the host. The
parameters are updated in place in the module (one copy of the weights);
the batchnorm running statistics and the Adam moments are values in the
``TrainState``, so that a skipped step keeps them too.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.models import tacotron2 as model_lib
from tacotron2_tpu_torch.training.loss import LossBreakdown, tacotron2_loss

if TYPE_CHECKING:
    from tacotron2_tpu_torch.parallel.sharding import ShardPlan

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

Tensors = Dict[str, torch.Tensor]


class Batch(NamedTuple):
    """One padded training batch."""
    text: torch.Tensor          # (B, T_in) int
    text_lengths: torch.Tensor  # (B,) int
    mel: torch.Tensor           # (B, T_out, n_mels) fp32
    gate_target: torch.Tensor   # (B, T_out) fp32, 1.0 from the last real frame
    mel_lengths: torch.Tensor   # (B,) int
    # (B,) fp32 validity of rows that pad a partial batch; None: all real
    row_valid: Optional[torch.Tensor] = None


class TrainState(NamedTuple):
    step: torch.Tensor           # () int32, advances on every step
    model: model_lib.Tacotron2   # the parameters, trainable, updated in place
    stats: Tensors               # batchnorm running statistics (bn_stats)
    exp_avg: Tensors             # fp32 Adam first moments, by parameter name
    exp_avg_sq: Tensors          # fp32 Adam second moments
    adam_count: torch.Tensor     # () int32, advances on applied steps only
    learning_rate: torch.Tensor  # () fp32
    # parallel.sharding.ShardPlan at mp > 1: the moments of the parameters
    # it names hold this rank's part only; None: every moment is whole
    shard: Optional["ShardPlan"] = None


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    mel_loss: torch.Tensor
    postnet_loss: torch.Tensor
    gate_loss: torch.Tensor
    grad_norm: torch.Tensor
    applied: torch.Tensor  # 1.0 when the update was applied, 0.0 if skipped


def compute_dtype(cfg: Tacotron2Config) -> Optional[torch.dtype]:
    """The operand dtype of the products; None for full fp32."""
    return {"float32": None, "bfloat16": torch.bfloat16}[cfg.compute_dtype]


def create_train_state(cfg: Tacotron2Config, *,
                       generator: Optional[torch.Generator] = None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> TrainState:
    """A fresh state: the model with the reference's initialisation drawn
    from ``generator``, on ``device`` (CUDA unless the caller asks for the
    CPU), zero Adam moments, step 0 and ``cfg.learning_rate``."""
    device = model_lib.resolve_device(device)
    model = model_lib.Tacotron2(cfg, generator, trainable=True).to(device)
    return state_for(model, cfg)


def state_for(model: model_lib.Tacotron2, cfg: Tacotron2Config
              ) -> TrainState:
    """A fresh train state around an existing trainable model."""
    dev = next(model.parameters()).device
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in model.named_parameters()}
    scalar = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)
    return TrainState(scalar(0, torch.int32), model, model_lib.bn_stats(model),
                      zeros, {n: z.clone() for n, z in zeros.items()},
                      scalar(0, torch.int32),
                      scalar(cfg.learning_rate, torch.float32))


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum of every gradient element squared (optax's)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def guarded_update(state: TrainState, grads: Tensors, new_stats: Tensors,
                   loss: torch.Tensor, cfg: Tacotron2Config
                   ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """clip_by_global_norm(cfg.grad_clip_thresh) -> + weight_decay * param ->
    Adam(0.9, 0.999, eps 1e-8 after the square root, bias-corrected) ->
    times -learning_rate, as the JAX package's ``make_optimizer`` chain.
    When the loss or the gradient norm is not finite, parameters, moments,
    the Adam count and the batchnorm statistics keep their old values and
    only ``step`` advances; nothing is read back to the host. Returns
    (new state, grad_norm of the unclipped gradient, applied 1.0/0.0).

    With a shard plan (``state.shard``, mp > 1) the norm, the clip and the
    finiteness test still come from the whole gradient, which every rank
    holds; each sharded parameter is updated on this rank's part only,
    with its part of the moments, and the other parts are gathered from
    the mp group's ranks after the loop. Each element's arithmetic is the
    one it has without the plan."""
    plan = state.shard
    part = plan.part if plan is not None else (lambda name, t: t)
    g_norm = global_norm(grads)
    finite = torch.isfinite(loss) & torch.isfinite(g_norm)
    trigger = g_norm < cfg.grad_clip_thresh
    count = state.adam_count + 1
    c = count.float()
    one = torch.ones((), device=c.device)
    corr1 = 1 - (one * ADAM_B1) ** c
    corr2 = 1 - (one * ADAM_B2) ** c
    mu_new, nu_new, sharded = {}, {}, []
    with torch.no_grad():
        for name, whole in state.model.named_parameters():
            p = part(name, whole)
            g = part(name, grads[name]).float()
            g = torch.where(trigger, g, (g / g_norm) * cfg.grad_clip_thresh)
            g = g + cfg.weight_decay * p
            mu = (1 - ADAM_B1) * g + ADAM_B1 * state.exp_avg[name]
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.exp_avg_sq[name]
            upd = (mu / corr1) / (torch.sqrt(nu / corr2) + ADAM_EPS)
            new_p = p + (-upd) * state.learning_rate
            p.copy_(torch.where(finite, new_p, p))
            mu_new[name] = torch.where(finite, mu, state.exp_avg[name])
            nu_new[name] = torch.where(finite, nu, state.exp_avg_sq[name])
            if p is not whole:
                sharded.append((name, whole))
        if plan is not None:
            plan.gather_parts(sharded)
        stats = {k: torch.where(finite, new_stats[k], v)
                 for k, v in state.stats.items()}
    new_state = TrainState(state.step + 1, state.model, stats, mu_new, nu_new,
                           torch.where(finite, count, state.adam_count),
                           state.learning_rate, plan)
    return new_state, g_norm, finite.float()


def _check_device(state: TrainState, batch: Batch) -> None:
    where = next(state.model.parameters()).device
    if batch.mel.device.type != where.type:
        raise ValueError(f"the batch is on {batch.mel.device}, the model on "
                         f"{where}: train on one device")


def loss_and_grads(state: TrainState, batch: Batch, cfg: Tacotron2Config,
                   generator: Optional[torch.Generator] = None, group=None):
    """The training forward, the loss and the gradient of every parameter
    by name: (LossBreakdown, grads, new batchnorm statistics,
    ForwardOutput). ``group``: the data-parallel process group whose ranks
    hold the rest of the global batch; batchnorm takes its statistics over
    all of it (``parallel/step.py``)."""
    _check_device(state, batch)
    params = dict(state.model.named_parameters())
    with torch.enable_grad():
        output, new_stats = model_lib.forward(
            state.model, state.stats, batch.text, batch.text_lengths,
            batch.mel, batch.mel_lengths, cfg, training=True,
            generator=generator, compute_dtype=compute_dtype(cfg),
            bn_group=group)
        loss = tacotron2_loss(output, batch.mel, batch.gate_target)
        grads = torch.autograd.grad(loss.total, list(params.values()),
                                    allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    detach = lambda t: type(t)(*(x.detach() for x in t))
    return detach(loss), grads, new_stats, detach(output)


def train_step(state: TrainState, batch: Batch, cfg: Tacotron2Config,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[TrainState, StepMetrics, model_lib.ForwardOutput]:
    """One optimisation step on the state's device. ``generator`` draws
    every dropout mask (encoder convs, prenet, the two decoder LSTM
    outputs, postnet); None runs no dropout at all."""
    loss, grads, new_stats, output = loss_and_grads(state, batch, cfg,
                                                    generator)
    new_state, grad_norm, applied = guarded_update(state, grads, new_stats,
                                                   loss.total, cfg)
    metrics = StepMetrics(loss.total, loss.mel, loss.mel_postnet, loss.gate,
                          grad_norm, applied)
    return new_state, metrics, output


def eval_step(state: TrainState, batch: Batch, cfg: Tacotron2Config,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[LossBreakdown, model_lib.ForwardOutput]:
    """Validation loss on one batch: batchnorm on the running statistics,
    no dropout except the prenet's when a generator is given (the
    reference keeps it at validation), rows weighted by ``row_valid``."""
    _check_device(state, batch)
    with torch.no_grad():
        output, _ = model_lib.forward(
            state.model, state.stats, batch.text, batch.text_lengths,
            batch.mel, batch.mel_lengths, cfg, training=False,
            generator=generator, compute_dtype=compute_dtype(cfg))
        return (tacotron2_loss(output, batch.mel, batch.gate_target,
                               row_weights=batch.row_valid), output)


def make_batch(cfg: Tacotron2Config, B: int, T_in: int, T_out: int,
               seed: int = 0, device: Union[str, torch.device] = "cuda"
               ) -> Batch:
    """A synthetic padded batch from a numpy seed: random symbols, half the
    rows 3 symbols shorter, mel targets 0.3 N(0, 1) zero past each row's
    length (half the rows 8 frames shorter), gate targets 1 from the last
    real frame on. The same maker as the JAX package's benchmark batch."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, cfg.n_symbols, (B, T_in)).astype(np.int32)
    text_lengths = np.full((B,), T_in, np.int32)
    text_lengths[B // 2:] = max(2, T_in - 3)
    for b, n in enumerate(text_lengths):
        text[b, n:] = 0
    mel = rng.randn(B, T_out, cfg.n_mel_channels).astype(np.float32) * 0.3
    mel_lengths = np.full((B,), T_out, np.int32)
    mel_lengths[B // 2:] = max(4, T_out - 8)
    gate = np.zeros((B, T_out), np.float32)
    for b, n in enumerate(mel_lengths):
        mel[b, n:] = 0.0
        gate[b, n - 1:] = 1.0
    device = model_lib.resolve_device(device)
    t = lambda x: torch.from_numpy(x).to(device)
    return Batch(t(text), t(text_lengths), t(mel), t(gate), t(mel_lengths))
