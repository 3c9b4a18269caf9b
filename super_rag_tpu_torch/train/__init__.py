"""Training (port of the JAX package's train/): contrastive fine-tuning of
the dual encoder, on one card or over a (dp, tp) mesh of ranks, and the
cross-encoder on mined hard negatives."""

from super_rag_tpu_torch.train.contrastive import (
    TrainConfig,
    TrainState,
    create_train_state,
    gather_params,
    make_train_step,
    param_shardings,
    shard_params,
    train_mesh,
)

__all__ = [
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "gather_params",
    "make_train_step",
    "param_shardings",
    "shard_params",
    "train_mesh",
]
