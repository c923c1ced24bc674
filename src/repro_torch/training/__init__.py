"""LM training (``repro.training``'s counterpart): AdamW, the train step, its
sharded form and the parameter sharding rules."""
from .optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .train_step import TrainState, init_state, make_sharded_train_step, make_train_step  # noqa: F401
