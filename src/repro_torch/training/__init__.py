"""LM training (``repro.training``'s counterpart): AdamW and the train step."""
from .optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .train_step import TrainState, init_state, make_train_step  # noqa: F401
