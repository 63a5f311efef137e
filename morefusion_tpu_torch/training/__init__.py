"""Training of the port (``morefusion_tpu.training``): the train step."""

# flake8: noqa: F401

from .trainer import CadPointBank
from .trainer import TrainState
from .trainer import create_train_state
from .trainer import make_eval_step
from .trainer import make_loss_fn
from .trainer import make_train_step
from .trainer import stack_examples
