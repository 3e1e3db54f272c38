"""The training step: loss, train state, the guarded optimizer update."""

from tacotron2_tpu_torch.training.loss import (LossBreakdown, bce_with_logits,
                                               tacotron2_loss)
from tacotron2_tpu_torch.training.state import (Batch, StepMetrics,
                                                TrainState,
                                                create_train_state, eval_step,
                                                guarded_update, make_batch,
                                                train_step)

__all__ = ["Batch", "LossBreakdown", "StepMetrics", "TrainState",
           "bce_with_logits", "create_train_state", "eval_step",
           "guarded_update", "make_batch", "tacotron2_loss", "train_step"]
