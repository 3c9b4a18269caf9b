"""Training on one card (port of the JAX package's train/): contrastive
fine-tuning of the dual encoder, and the cross-encoder on mined hard
negatives.  The (dp, tp) mesh of the JAX package waits for the
multi-device slice."""

from super_rag_tpu_torch.train.contrastive import (
    TrainConfig,
    TrainState,
    create_train_state,
    make_train_step,
)

__all__ = [
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "make_train_step",
]
