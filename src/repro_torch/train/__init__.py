from .steps import (TrainState, decode_step, init_train_state, loss_fn,
                    prefill_step, train_step, value_and_grad)

__all__ = ["TrainState", "decode_step", "init_train_state", "loss_fn",
           "prefill_step", "train_step", "value_and_grad"]
