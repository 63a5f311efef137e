"""Training of the port (``morefusion_tpu.training``): the train and eval
steps, the device augmentation, the batch loader, evaluation, logging,
checkpoints and the loop ``loop.fit``."""

# flake8: noqa: F401

from .trainer import CadPointBank
from .trainer import TrainState
from .trainer import create_train_state
from .trainer import make_eval_step
from .trainer import make_loss_fn
from .trainer import make_train_step
from .trainer import stack_examples
from .trainer import warmup_cosine_decay_schedule
from .evaluator import Evaluator
from .evaluator import summarize_records
from .reporting import LogReport
from .reporting import load_args
from .reporting import write_args
from .checkpoints import CheckpointManager
from .checkpoints import export_backbone_npz
from .checkpoints import export_params_npz
from .checkpoints import import_backbone_npz
from .checkpoints import import_params_npz
from .data import BatchLoader
from . import loop
