"""The LM stack's training half on torch: the JAX package's ``training``
(optimizers, gradient compression, the train step) over trees of tensors
(``tree``)."""
from repro_torch.training.optim import OptConfig, apply_updates, init_opt_state  # noqa: F401
from repro_torch.training.compress import GradCompressor  # noqa: F401
from repro_torch.training.train_step import TrainState, init_state, make_train_step  # noqa: F401
