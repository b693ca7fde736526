"""LM training in the port: AdamW over the fp32 masters, the train step with
microbatching and remat, and the (compressed) data-parallel step."""
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state
from .train_step import (TrainState, compressed_psum, init_train_state, loss_and_grads,
                         loss_fn, make_dp_train_step, make_train_step)

__all__ = ["AdamWConfig", "OptState", "adamw_update", "init_opt_state",
           "TrainState", "init_train_state", "loss_fn", "loss_and_grads", "make_train_step",
           "compressed_psum", "make_dp_train_step"]
